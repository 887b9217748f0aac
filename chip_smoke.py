#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`sos_tpu_torch`) on one NVIDIA card and check it.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a nonzero exit:

1. card: `nvidia-smi` name and power limit, torch and CUDA versions;
2. build: the kernels from `sos_tpu_torch/csrc/` with nvcc, timed;
3. kernels: K1-K4 and K6-K7 at the main path's shapes (128 clips),
   K1-K3 also in CUDA graphs (device time without the host's dispatch),
   K4 per case with its plan (rows a block, cluster, lanes a unit,
   blocks), the card's answer to cudaOccupancyMaxActiveClusters
   at its cluster size and its instances' registers and spills from
   ptxas, beside cuDNN's
   `nn.LSTM` in fp32 less its identity input projections (its library
   time) and with TF32 allowed,
   each against its plain PyTorch version on the card (K6 and K7
   exactly, in every loader and epilogue form the main path runs, K6 on
   the routes the main path takes: the wgmma halo tile, and the
   first-layer and projection kernels at each of their five main-path
   shapes, in records of their own, the projection beside
   `torch._int_mm` plus its epilogue as torch ops; K7 on its wgmma
   tile, down, stride-2 and sub-pixel up blocks), with
   the kernel's, the plain version's and the library call's times, TOPS
   and the kernel's bound; the length-bucketed cases of phase 7's path
   the same way: K1 with center=False on 128 rows of a 1,024-frame
   bucket (beside `torch.stft(center=False)`), K3 with per-row valid_t
   over 2-1,024 frames at 16 rows, K4 with per-row lengths at T 1,024 /
   H 200 and T 384 / H 100, 16 rows (beside cuDNN over a packed
   sequence), and at the eval chain's 8 rows with the longest row at
   0.6 T (checked and logged: µs a step of the longest row, the plan);
   those of phase 7's int8 path: K6 with per-row valid_t
   (enc_x block 7 on the tile and the Cin 2 first block on the
   first-layer kernel) and K7 with per-row valid_t
   on rows in segments (a_in, a_d1, mid_dil16, mid_up), 8 rows of a
   1,024-frame bucket, valid widths over 2-1,024 with garbage past them,
   exactly, each beside the share of its items that the masked instance
   computes (live items), that instance's time with every row full
   (exact too) and the unmasked instance's at the same shape, and K7
   without valid_t at the same widths (the exact mode's long rows on the
   tile); the training path's instances (phase 8's
   shapes): K4's training instance (h bit-identical to the inference
   instance's, c and gates within 1e-6 of one step from the kernel's
   own state) and K4b (the BiLSTM backward, against its plain version
   on the same saved state; its plan logged with the card's
   cudaOccupancyMaxActiveClusters and ptxas' registers and spills, and
   its exchange-only floor: `scripts/k4b_sweep.py`'s exchange alone of
   the same plan, built into `build/k4b_floor/`, beside its bound) at
   B 15 T 60 / H 100 and B 40 T 178 / H 200
   (and, logged with its bound, the joint step's B 15 T 178 / H 200)
   beside cuDNN's fp32 `nn.LSTM` in training (forward, and backward of
   the data gradient, each less its identity projections), and K2's
   complement instance at (15, 28000) and (40, 28000), exactly; the
   BiLSTM's wide route past the register plans (`csrc/bilstm_wide.cu`):
   K4 without and with per-row lengths, its training instance and K4b at
   B 16, T 178, H 256 and H 512 against their plain versions (K4's and
   K4b's tolerances), each plan logged with the blocks the card holds at
   once, beside cuDNN's fp32 `nn.LSTM` less its projections; K5 at
   every shape of the int8 GEMM sweep (the
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
   torch.profiler breakdown (K6 by route: tile, first layer,
   projection, gather); the profiled int8 call must launch the
   first-layer and projection kernels 3 times each and the gather
   never;
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
   finite; then the predictors alone in f32, bf16 and int8 (int8 loading
   phase 4's scale file), bucketed and exact (audio-s/s for detect and
   denoise; bucketed, beside the chain's fill: the utterances' frames
   over the frames of its tiles), with bucketed against exact within
   1e-4 with equal bits (int8: 2e-5 confidences, 3e-5 waveforms,
   sos_tpu's bounds), bf16
   bits agreeing with f32 on at least 98 % of frames, the int8 chain
   through K6's and K7's valid_t cases and never through K7's mma.sync
   gather, and the card against the CPU on the 2.0 s and 7.4 s
   utterances (int8: the 2.0 s one and the shortest over 2.1 s,
   bucketed) within 1e-3 with equal bits;
8. training: full width, fresh seeded weights, synthetic clips. One
   detector and one denoiser train step at batch 2 from the same
   weights and batch, on the card and on the CPU, which steps on the
   card's device-stage outputs and, apart, on its own (loss within 1e-4
   relative and the new BatchNorm statistics within 1e-5 in both; all
   gradients within 5e-2 relative L2 on the card's inputs; the BiLSTM's
   and heads' gradients within 1e-3 of each tensor's max |g| from the
   card step's own head features and logits' gradient; logged beside
   them: the features' drift, the own-input step and the card against
   itself with deterministic cuDNN; K1, K2, K2's complement, K4's
   training instance and K4b must launch); the train step timed at
   batch 15 (detector) and 40 (denoiser), remat on: median of 5 steps
   after 2, clips/s, audio-s/s trained, peak memory, a torch.profiler
   breakdown of one step; then `python -m
   sos_tpu_torch.cli.train_detector` at full width on a generated corpus
   (1 epoch, `latest` every step, batch 4), and `--continue --ckpt
   latest` to epoch 2: `latest.clock.json` must advance and stay strict
   JSON;
9. joint and bf16 training, checkpoints end to end: full width, fresh
   seeded weights, synthetic clips. The joint step at batch 2 on the card
   (K1, K2, K2's complement once, K4's training instance and K4b twice)
   and each stage's part of it, card against CPU on the card's
   device-stage outputs, with phase 8's bounds; one bf16 `--no_remat`
   step of each stage at batch 2 against the card's f32 step on the same
   inputs, within `BF16_BOUNDS` (sos_tpu's own bf16-vs-f32 gap at the
   reference depth), its BiLSTM's and heads' gradients card against CPU
   within 1e-3 of max |g|, and against the CPU's bf16 step when that
   should take under 60 s; timed steps (as phase 8) of the joint step,
   f32 with remat, at batch 15, and bf16 without remat of the detector
   at 15, the denoiser at 40 (or the largest batch that fits) and the
   joint step at 15; then the CLIs in this process on a generated
   corpus: `train_joint` (1 epoch, batch 4) -> `predict_detector --ckpt
   latest` -> `bridge` -> `predict_denoiser --ckpt latest` (11 finite
   metrics; K3 and K4 launch), `denoise --detector_ckpt latest
   --denoiser_ckpt latest --profile int8` (the scale file, finite audio;
   K6 and K7 launch), and `import_checkpoint` of a reference-layout
   `ckpt_epoch3.pth` (the weights back exactly) then `train_detector
   --continue --ckpt 3 --epochs 4` (`latest.clock.json` at epoch 4);
10. data parallelism and the synthetic eval, at full width: (a) two
   ranks on the one card in a gloo process group with CUDA tensors
   (NCCL refuses two ranks on one device), spawned processes, one
   detector and one denoiser step at a local batch of 2 against one
   process at 4 on the card: the ranks' new states bit-identical, loss
   within 1e-4 relative, BatchNorm statistics 1e-5, gradients 5e-2
   relative L2 (phase 8's bounds), K1, K2's complement, K4's training
   instance and K4b launched in each rank; (b) NCCL at world size 1
   under torchrun's variables: `train_denoiser --distributed` for 1
   epoch on a generated corpus, then `--continue` to epoch 2, and the
   synced denoiser step timed at batch 40 beside phase 8's plain step
   (the cost of the sync-BN and gradient all-reduces); (c)
   `FusedDenoisePipeline.shard` over every visible card against the
   unsharded call, f32 and int8, the card count printed; (d)
   `eval_synthetic --noisy_baseline` in f32, bf16 and int8 on (b)'s
   checkpoint, SNR indices 0/3/6, batch 8, 2 batches: 11 finite metrics
   at each SNR and the eval's kernels launched; the device part's
   audio-s/s, the host metric seconds, and one batch on the card against
   the CPU within 1e-3 (f32).

11. the deployment path, at full width on a generated corpus of eight
   8.5 s WAVs: (a) `calibrate` in this process at `--clip_seconds 2`
   (K1, K2, K4 launch), at 8 s (K2's gather-map table launches) and at
   2 s with `despeckle_min_run` 600 (K2's despeckle instance launches),
   4 clips each, the 2 s scale file against the CPU's on the same clips
   within rtol 1e-5 with equal bits (threshold where the float
   detector's probabilities split); (b) `export_serving` of an f32
   batch-16 2 s, an int8 batch-8 8 s and an int16-wire int8 batch-16
   2 s artifact (int8 with (a)'s 2 s file), each loaded with
   `load_denoise_program` on the card (one CUDA graph) and held against
   the eager pipeline on the card (bits equal, 1e-5) and the same
   artifact's pipeline on the CPU over its first 1-4 rows (1e-3, equal
   bits; the CPU's plain int8 path is slow), the
   kernels launched at capture checked; the median of 10 replayed calls
   beside 10 eager calls at batch 128, 2 s (int8, bf16), in audio-s/s;
   (c) `doctor --json` on (b)'s experiment (accelerator, compile-cache,
   native-engine and the experiment's checks ok, exit 0); (d)
   `parity_check` on full-size fabricated reference `.pth` files over 4
   short utterances: finite statistics, its own output as manifest
   exits 0, one perturbed tensor exits 1; (e) `python -m sos_tpu_torch
   --help` and `doctor` through the dispatcher; (f) the native audio
   engine builds and its threaded decode equals the Python decode
   exactly;
12. the training tools and other STFT geometries: (a) `python -m
   sos_tpu_torch preprocess --label_silence` in this process on WAVs at
   44.1 and 14 kHz (host work), each bitstream read back through
   `DatasetIndex` against `label_bitstream` on the decoded WAV; (b)
   `fit` at full width, the denoiser for 2 steps at batch 4 with
   `visualize_frequency` 1 and a recording writer: the hook fires at
   every step, its panel waveforms (`denoiser_batch_panels`, K3
   `crm_istft` among their launches) within 1e-3 of the same call on
   the CPU on the first item, rendered by `make_denoiser_visualize_hook`
   where matplotlib imports (said beforehand); (c) `report
   --results_dir` on phase 7's detector and denoiser outputs and
   `--train_log` on (b)'s log: exit 0, finite tables; (d)
   `QuantizedDenoiser(inpaint_dtype="bfloat16")` at full width, 16 x 2
   s, calibrated on the first 2 rows on the card and on the CPU: cRM
   within 1e-3 there, K6 launched and K7 not, its ms beside the int8
   mode's; (e) the f32 pipeline at (1022, 256, 1022) with 512 bins and
   at (254, 64, 254) with 128, seeded weights, 16 x 2 s, against the CPU
   on 2 rows (bits equal off the threshold, those within 1e-4 of it
   counted; waveform within 1e-3), K1/K3's "fft" instances launched at
   the first and the generic ones at the second (`kernel_instance`), the
   others and the default prime-factor ones not, audio-s/s beside the
   default geometry's; at the first, bf16 (the detector's confidences within
   1e-3 of f32's, the spread of f32's printed beside; the bits equal on
   every frame farther than that drift from the threshold, at least
   half the frames; the waveform on the f32 bits within 2e-2 relative
   L2) and int8 (K6 and K7 at F = 512; the card calibrates, the
   CPU loads its scale file; 1 row against the CPU); at both, the
   length-bucketed denoiser (K1 center=False and K3 with valid_t on the
   geometry's instances; the card against the CPU on a 1.5 s utterance);
13. the BiLSTM past H 224 and the fast profile: `ExperimentConfig()` with
   both stages' `lstm_hidden` at 256, seeded weights: one f32 call at
   batch 2 and one denoiser train step at batch 2 on the card against
   the CPU (phase 4's and phase 8's bounds; K4's wide route, its training
   instance and K4b must launch); then `fast_denoiser_config()`: one f32
   and one int8 call at batch 1 against the CPU path.

K3's valid_t cases (phase 3, at every geometry) must also be exactly 0
from each row's live reach on, where their dead blocks store zeros.

Phase 3 also holds K1's and K3's instances at other geometries against
their plain versions, eager and in a CUDA graph beside torch.stft /
torch.istft, each geometry printed: the "fft" instances (a prime-factor
FFT from `fft_tables`) at (128, 28000) at (1022, 256, 1022), (511, 158,
400) and (512, 128, 512) and their inverses, K1 center=False on 128 rows
and K3 with per-row valid_t on 16 rows of a 1,024-frame bucket at (1022,
256, 1022); the generic instances (the dense product over the
float64-built tables) the same way at (254, 64, 254), where 127 points
do not factor. Bounds: bytes, and the instance's operations (an FFT's for
the dense instance, the dense product's GFLOP beside it).

Phase 3 also holds K7 on a short utterance's row (mid_dil16, pad 16 on
12 columns, `reflect_prepad` then pad 0) against its plain version,
exactly, and checks that it launched; and K2's long windows (8 x 60 s
and 2 x 600 s, 18,000 frames, gate and complement: the gather maps'
table) and its generic despeckle (`despeckle_min_run` 600 at 2 s and 8
s, gate and complement), exactly, each timed with its bound.

The line before the last is the kernels' JSON record; the last line is
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from sos_tpu_torch.cli.serve import ServeLoop
from sos_tpu_torch.config import (DenoiserModelConfig, DetectorModelConfig,
                                  ExperimentConfig, StftConfig,
                                  fast_denoiser_config)
from sos_tpu_torch.dsp import audio_io
from sos_tpu_torch.dsp.mixing import mask_gate, mask_gate_plain
from sos_tpu_torch.dsp.stft import (FFT_DENSE, FFT_PASS_INTS,
                                    FFT_PLAN_HEADER, crm_istft,
                                    crm_istft_plain, device_pfa_tables,
                                    fft_points, fft_tables, kernel_instance,
                                    padded_window,
                                    stft, stft_cat, stft_cat_plain,
                                    stft_num_frames)
from sos_tpu_torch.infer import StreamingDenoiser, StreamingSession
from sos_tpu_torch.infer.fused import FusedDenoisePipeline, _nchw
from sos_tpu_torch.kernels import (ENTRY_LAUNCHES, LAUNCHES, library,
                                   reset_launches)
from sos_tpu_torch.kernels.build import build
from sos_tpu_torch.models import JointDenoiser, SilenceDetector
from sos_tpu_torch.models.layers import exact_fp32, init_state_dict
from sos_tpu_torch.ops.int8_conv import (conv_same_int8, conv_same_int8_plain,
                                         conv_same_route, inpaint_conv_int8,
                                         halo_plan, inpaint_conv_int8_plain,
                                         inpaint_plan, inpaint_valid_out,
                                         needs_prepad, up_pads)
from sos_tpu_torch.ops.int8_gemm import (gemm_plan, int8_matmul_nt,
                                         int8_matmul_plain, narrow_n_sweep,
                                         sweep_operands)
from sos_tpu_torch.ops.lstm import (BackwardPlan, WidePlan, backward_plan,
                                    bilstm_recurrence,
                                    bilstm_recurrence_backward,
                                    bilstm_recurrence_backward_plain,
                                    bilstm_recurrence_plain,
                                    bilstm_recurrence_train,
                                    bilstm_recurrence_train_plain,
                                    bilstm_step_states, coresident_blocks,
                                    max_active_clusters, recurrence_plan)
from sos_tpu_torch.ops.resize import nearest_index_tensor
from sos_tpu_torch.train import joint
from sos_tpu_torch.train import loop as train_loop
from sos_tpu_torch.train.checkpoints import load_model_state

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


_K4_PTXAS = None


def k4_plan_note(plan) -> str:
    """A K4 or K4b plan as phase 3 logs it: rows a block, cluster, lanes
    a unit, float4 columns of W_hh a lane holds, blocks, threads and
    shared bytes, the card's `cudaOccupancyMaxActiveClusters` at its
    cluster size (against the clusters it launches), and the registers
    and spills ptxas reported for its instances (K4: inference and
    training; the build's log)."""
    global _K4_PTXAS
    if _K4_PTXAS is None:
        _K4_PTXAS, key = {}, None
        text = build().with_suffix(".log").read_text()
        pat = re.compile(r"(bilstm(?:_train|_bwd)?_kernel)I((?:Li\d+E)+)")
        for line in text.splitlines():
            if "Compiling entry function" in line:
                m = pat.search(line)
                key = ((m.group(1),) + tuple(
                    int(n) for n in re.findall(r"Li(\d+)E", m.group(2)))
                    if m else None)
            elif key and "spill stores" in line:
                nums = [int(n) for n in re.findall(r"(\d+) bytes", line)]
                spills = sum(nums[1:3])
            elif key and "Used" in line and "registers" in line:
                _K4_PTXAS[key] = (int(re.search(r"Used (\d+) registers",
                                                line).group(1)), spills)
                key = None
    head = (plan.bt, plan.cluster, plan.split, plan.kv)
    kernels = ((("K4b", ("bilstm_bwd_kernel",) + head + (0,)),)
               if isinstance(plan, BackwardPlan) else
               (("inference", ("bilstm_kernel",) + head + (0,)),
                ("training", ("bilstm_train_kernel",) + head)))
    regs = "; ".join(
        f"{k} {_K4_PTXAS[v][0]} registers, {_K4_PTXAS[v][1]} B spilled"
        if v in _K4_PTXAS else f"{k}: no ptxas line" for k, v in kernels)
    clusters = plan.blocks // plan.cluster
    held = max_active_clusters(plan)
    group = "quad of units" if isinstance(plan, BackwardPlan) else "unit"
    return (f"{plan.bt} rows a block, cluster {plan.cluster}, {plan.split} "
            f"lanes a {group}, {plan.kv} float4 columns a lane, {plan.blocks} "
            f"blocks of {plan.threads} threads, {plan.smem_bytes} B shared; "
            f"cudaOccupancyMaxActiveClusters {held} at cluster "
            f"{plan.cluster} for {clusters} clusters "
            f"({'one wave' if clusters <= held else 'waves of clusters'}); "
            f"{regs}")


def k4b_floor_calls():
    """The exchange alone of each training shape's K4b plan (the
    sweep's mode 8: no sum over W_hh, no cell arithmetic), built by
    `scripts/k4b_sweep.py` into `build/k4b_floor/`: a function of
    (plan, dout, gates, c, w_f, w_b, dxp) giving a closure that launches
    it. Its time is K4b's exchange-only floor."""
    import importlib.util
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "k4b_sweep", os.path.join(here, "scripts", "k4b_sweep.py"))
    sweep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sweep)
    keys = [sweep.shipped(b, h)[1][1:]
            for b, _, h in TRAIN_LSTM_SHAPES + TRAIN_LSTM_LOGGED]
    t0 = time.perf_counter()
    lib, _ = sweep.build_variants(
        keys, Path(here) / "build" / "k4b_floor")
    log(f"K4b exchange-only instances built in "
        f"{time.perf_counter() - t0:.1f} s")

    def call(plan, *tensors):
        return sweep.variant_call(lib, 8, plan, plan.smem_bytes, *tensors)
    return call


def cudnn_inference_ms(xp_f, w_f, w_b, dev):
    """cuDNN's `nn.LSTM` on K4's function: identity input weights, zero
    biases. (fp32 ms, its two identity input projections' fp32 ms, ms
    with TF32 allowed); the recurrence alone is the first less the
    second."""
    g4, hidden = w_f.shape
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
    with exact_fp32():
        fp32_ms, proj_ms = time_ms(cudnn), time_ms(projections)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
        tf32_ms = time_ms(cudnn)
    return fp32_ms, proj_ms, tf32_ms


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


def zeros_past_reach(kernel, valid_t, n_fft, hop):
    """K3 with per-row valid_t: every sample from a row's live reach on
    (past the last sample its last live frame reaches, where the valid_t
    instances' dead blocks store zeros) is exactly 0. Returns (ok, the
    samples checked)."""
    reach = torch.clamp((valid_t - 1) * hop + n_fft - n_fft // 2, min=0)
    reach = torch.where(valid_t > 0, reach, torch.zeros_like(reach))
    past = (torch.arange(kernel.shape[1], device=kernel.device)[None]
            >= reach[:, None])
    return bool((kernel[past] == 0).all()), int(past.sum())


def within_valid(kernel, plain, valid_t, n_fft, hop, win, atol, rtol):
    """K3 with per-row valid_t against its plain version: within atol +
    rtol on the samples a caller keeps, j < (valid_t - 1) hop (the
    predictors slice there; `istft_packed`), and, on every sample, the
    overlap-added sum before the envelope divide (the output times the
    row's envelope) within atol + rtol. Past (valid_t - 1) hop only the
    tail of the last valid frame reaches a sample, the divide by its
    squared window value (down to ~1e-10 at win = n_fft) amplifies fp32
    rounding, and the plain version's own error there exceeds the
    tolerance. Past the live reach the kernel's output must be exactly 0
    (`zeros_past_reach`). Returns (max error on the kept samples, ok, a
    note with the samples outside atol + rtol in a plain comparison)."""
    rows, out_len = plain.shape
    frames = (out_len - n_fft % 2) // hop + 1
    mask = (torch.arange(frames, device=plain.device)[None]
            < valid_t[:, None]).double()
    wsq = torch.from_numpy(padded_window(n_fft, win) ** 2).to(plain.device)
    env = torch.zeros(rows, (frames - 1) * hop + n_fft, dtype=torch.float64,
                      device=plain.device)
    for t in range(frames):
        env[:, t * hop:t * hop + n_fft] += mask[:, t:t + 1] * wsq
    env = env[:, n_fft // 2:n_fft // 2 + out_len]
    keep = (torch.arange(out_len, device=plain.device)[None]
            < ((valid_t - 1) * hop)[:, None])
    err = (kernel - plain).abs()
    bad = err > atol + rtol * plain.abs()
    num_err = (kernel.double() - plain.double()).abs() * env
    num_ok = bool((num_err <= atol + rtol * (plain.double() * env).abs()).all())
    past = bad & ~keep
    zero_ok, zero_n = zeros_past_reach(kernel, valid_t, n_fft, hop)
    note = (f"exactly 0 on the {zero_n} samples past the rows' live reach "
            f"{zero_ok}; plain comparison: {int(bad.sum())} samples outside, "
            f"{int(past.sum())} of them past (valid_t - 1) hop"
            + (f" (envelope there {float(env[past].min()):.3e}-"
               f"{float(env[past].max()):.3e})" if past.any() else "")
            + f"; summed frames max |error| {float(num_err.max()):.3e}")
    return (float(err[keep].max()),
            bool(not (bad & keep).any()) and num_ok and zero_ok, note)


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
        log(f"bilstm T{steps}/H{hidden} plan: {k4_plan_note(plan)}; units "
            f"{[n for _, n in plan.units]}")
        got = bilstm_recurrence(xp_f, xp_b, w_f, w_b)
        ref = bilstm_recurrence_plain(xp_f, xp_b, w_f, w_b)
        torch.cuda.synchronize()
        err, ok = within(got, ref, 5e-5, 0.0)
        ms = time_ms(lambda: bilstm_recurrence(xp_f, xp_b, w_f, w_b))
        plain_ms = time_ms(lambda: bilstm_recurrence_plain(xp_f, xp_b, w_f, w_b),
                           reps=3, warmup=1)
        fp32_ms, proj_ms, tf32_ms = cudnn_inference_ms(xp_f, w_f, w_b, dev)
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
    k2_window_cases(torch.Generator().manual_seed(SEED + 2), dev, record)
    # a generator of its own: the later phases keep the weights and data
    # they were validated on (drawn from `gen`). Phase 7's corpus holds
    # no resize tie (see `resize_ties`)
    training_cases(torch.Generator().manual_seed(SEED + 1), dev, record)
    wide_lstm_cases(torch.Generator().manual_seed(SEED + 6), dev, record)

    stft_instance_cases(torch.Generator().manual_seed(SEED + 3), dev, record)

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
    k6_results = {}  # label -> result of a K6 case, each shape run once
    for name, source, replaces, cases in (
            ("int8_conv", "sos_tpu_torch/csrc/int8_conv.cu",
             "sos_tpu/models/quant.py:136", K6_CASES),
            ("int8_inpaint", "sos_tpu_torch/csrc/int8_inpaint.cu",
             "sos_tpu/models/quant.py:457", K7_CASES)):
        total = {"ms": 0.0, "plain_ms": 0.0, "ops": 0.0, "bytes": 0.0,
                 "err": 0.0, "exact": True}
        for case in cases:
            res = int8_conv_case(name, case, cgen, dev)
            if name == "int8_conv":
                k6_results[case[0]] = res
            for key in ("ms", "plain_ms", "ops", "bytes"):
                total[key] += res[key]
            total["err"] = max(total["err"], res["err"])
            total["exact"] = total["exact"] and res["exact"]
        record(name, source, replaces, total["err"], total["exact"], "exact",
               total["ms"], total["plain_ms"], None, total["ops"],
               total["bytes"], PEAK_INT8_OPS,
               shape=" + ".join(c[0] for c in cases) + " at B 128 (sum)")
    # K6's first-layer and projection kernels at each of their main-path
    # shapes (bound by bytes); the projection beside torch._int_mm and
    # its epilogue as torch ops. A shape the four-case sum ran keeps its
    # result there; the others draw from a generator of their own, so the
    # cases after them keep the data of earlier runs
    egen = torch.Generator(device=dev).manual_seed(SEED + 4)
    for name, cases in (("int8_conv_first", K6_FIRST_CASES),
                        ("int8_conv_proj", K6_PROJ_CASES)):
        total = {"ms": 0.0, "plain_ms": 0.0, "ops": 0.0, "bytes": 0.0,
                 "err": 0.0, "exact": True, "library_ms": 0.0}
        for case in cases:
            res = k6_results.get(case[0])
            if res is None:
                res = int8_conv_case("int8_conv", case, egen, dev)
            for key in ("ms", "plain_ms", "ops", "bytes", "library_ms"):
                total[key] += res.get(key, 0.0)
            total["err"] = max(total["err"], res["err"])
            total["exact"] = total["exact"] and res["exact"]
        record(name, "sos_tpu_torch/csrc/int8_conv_edge.cu",
               "sos_tpu/models/quant.py:136", total["err"], total["exact"],
               "exact", total["ms"], total["plain_ms"],
               total["library_ms"] if name == "int8_conv_proj" else None,
               total["ops"], total["bytes"], PEAK_INT8_OPS,
               shape=" + ".join(c[0] for c in cases) + " at B 128 (sum)")
    for case in K6_LOGGED_CASES:  # checked and logged, outside the sum
        int8_conv_case("int8_conv", case, cgen, dev)
    for case in K7_LOGGED_CASES:
        int8_conv_case("int8_inpaint", case, cgen, dev)

    # the length-bucketed cases of K6 and K7 (phase 7's int8 path):
    # EVAL_BATCH rows of a 1,024-frame bucket, per-row valid widths over
    # 2-1,024 with garbage past them; K7's rows in segments. Their bounds
    # count the valid positions' operations and bytes
    for name, source, replaces, kernel, cases in (
            ("int8_conv_valid_t", "sos_tpu_torch/csrc/int8_conv.cu",
             "sos_tpu/models/quant.py:136", "int8_conv", K6_VALID_CASES),
            ("int8_inpaint_valid_t", "sos_tpu_torch/csrc/int8_inpaint.cu",
             "sos_tpu/models/quant.py:457", "int8_inpaint", K7_VALID_CASES)):
        total = {"ms": 0.0, "plain_ms": 0.0, "ops": 0.0, "bytes": 0.0,
                 "err": 0.0, "exact": True}
        for case in cases:
            res = int8_conv_case(kernel, case, cgen, dev, batch=EVAL_BATCH,
                                 valid=True)
            for key in ("ms", "plain_ms", "ops", "bytes"):
                total[key] += res[key]
            total["err"] = max(total["err"], res["err"])
            total["exact"] = total["exact"] and res["exact"]
        record(name, source, replaces, total["err"], total["exact"], "exact",
               total["ms"], total["plain_ms"], None, total["ops"],
               total["bytes"], PEAK_INT8_OPS,
               shape=" + ".join(c[0] for c in cases)
               + f" at B {EVAL_BATCH}, per-row valid_t 2-1024 (sum)")
    for case in K7_LONG_CASES:  # the exact mode's long rows, no valid_t
        int8_conv_case("int8_inpaint", case, cgen, dev, batch=EVAL_BATCH)
    # a short utterance's mid_dil16 (pad 16 on 12 columns): through K7
    # (one launch a call), exactly as its plain version
    for case in K7_SHORT_CASES:
        before = LAUNCHES["int8_inpaint"]
        int8_conv_case("int8_inpaint", case, cgen, dev, batch=EVAL_BATCH)
        if LAUNCHES["int8_inpaint"] == before:
            raise RuntimeError(f"int8_inpaint {case[0]}: K7 never launched")
    return rows, k5_launches


# K1's and K3's instances at other STFT geometries: (n_fft, hop, win) of
# the "fft" instances' centered STFT at (128, 28000) and its inverse, one
# row each summed over the geometries, and of their bucketed cases (K1
# center=False on 128 rows, K3 with per-row valid_t on 16 rows, of a
# 1,024-frame bucket); the generic (dense) instances at a geometry the
# "fft" ones do not take (127 points), centered and bucketed
FFT_GEOMETRIES = ((1022, 256, 1022), (511, 158, 400), (512, 128, 512))
FFT_BUCKETED = (1022, 256, 1022)
GENERIC_GEOMETRY = (254, 64, 254)
BUCKET_FRAMES = 1024


def fft_flops_per_frame(n_fft: int) -> float:
    """fp32 operations of one frame of a real FFT of n_fft points (~2.5 n
    log2 n) plus the window: the least arithmetic of K1's and K3's
    function at a geometry no prime-factor table covers."""
    return 2.5 * n_fft * np.log2(n_fft) + n_fft


def fft_instance_flops(n_fft: int, inverse: bool) -> float:
    """fp32 operations of one frame of K1's (forward) or K3's (inverse)
    "fft" instance as `fft_tables`' plan factorizes it: a dense q-point
    pass 8h^2 + 14h a DFT (h = (q-1)/2, `pfa_flops_per_frame`'s count), a
    radix-4 butterfly 34 (16 additions, 3 complex products), a radix-2 one
    10, over a transform of M points (a frame pair at odd n_fft, so half a
    transform a frame); K1 adds the window (n_fft) and the split (16 a
    bin); K3 the recover and product (20 a bin), the inverse split (12 a
    point), the window (n_fft) and the overlap-add with the envelope (17
    a sample of the frame's hop, counted as n_fft / 4)."""
    m, bins = fft_points(n_fft), n_fft // 2 + 1
    plan = fft_tables(n_fft, n_fft)["plan"]
    passes = 0.0
    for i in range(int(plan[2])):
        kind, n = (int(v) for v in plan[FFT_PLAN_HEADER + FFT_PASS_INTS * i:][:2])
        if kind == FFT_DENSE:
            h = (n - 1) // 2
            passes += m // n * (8 * h * h + 14 * h)
        else:
            passes += m // kind * (34 if kind == 4 else 10)
    per_frame = passes / (1 + n_fft % 2)
    if not inverse:
        return per_frame + n_fft + 16 * bins
    return per_frame + 20 * bins + 12 * m / (1 + n_fft % 2) + n_fft + 17 * n_fft / 4


def stft_instance_cases(gen, dev, record):
    """K1's and K3's "fft" instances (the prime-factor FFT from
    `fft_tables`) and generic instances (the dense product over the
    float64-built tables) against their plain versions, eager, in a CUDA
    graph, beside torch.stft / torch.istft at the same geometry, each
    geometry printed; the bound counts the bytes in and out once and the
    instance's operations (an FFT's for the dense instance, whose product's
    GFLOP is logged beside it). Each case checks that its instance
    launched."""
    def case(name, fn, plain, lib, flops, nbytes, shape, rows, dense=None,
             compare=None):
        before = LAUNCHES[name]
        got, ref = fn(), plain()
        torch.cuda.synchronize()
        if LAUNCHES[name] != before + 1:
            raise RuntimeError(f"{name} {shape}: {name} did not launch")
        err, ok = within(got, ref, 1e-4, 1e-4)
        if compare is not None:
            err, ok, note = compare(got, ref)
            log(f"{name} {shape}: {note}")
        ms, plain_ms = time_ms(fn), time_ms(plain)
        lib_ms = None if lib is None else time_ms(lib)
        g_ms = graph_ms(fn)
        b_ms, by = bound(flops, nbytes)
        extra = ("" if dense is None else
                 f"; dense product {dense / 1e9:.2f} GFLOP = "
                 f"{dense / PEAK_FP32_FLOPS * 1e3:.4f} ms at the fp32 peak, "
                 f"{dense / ms / 1e9:.1f} TFLOP/s")
        log(f"{name} {shape}: max_abs_err {err:.3e} (tolerance atol 1e-4 + "
            f"rtol 1e-4) {'ok' if ok else 'FAILED'}  kernel {ms:.4f} ms (in "
            f"a CUDA graph {g_ms:.4f})  plain {plain_ms:.4f} ms  library "
            f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}  bound "
            f"{b_ms:.4f} ms ({by}); {flops / 1e9:.3f} GFLOP{extra} "
            f"{card_note()}")
        if not ok:
            raise RuntimeError(f"{name} {shape}: kernel disagrees with its "
                               "plain version")
        for key, val in (("err", err), ("ms", ms), ("plain_ms", plain_ms),
                         ("lib_ms", lib_ms), ("flops", flops),
                         ("bytes", nbytes)):
            if key == "err":
                rows[key] = max(rows.get(key, 0.0), val)
            elif key == "lib_ms" and (val is None or rows.get(key, 0.0)
                                      is None):
                rows[key] = None
            else:
                rows[key] = rows.get(key, 0.0) + val
        rows.setdefault("shapes", []).append(shape)

    def centered(instance, nf, hop, win, k1, k3):
        bins, frames = nf // 2 + 1, stft_num_frames(CLIP, nf, hop)
        out_len = (frames - 1) * hop + nf % 2
        window = torch.from_numpy(padded_window(nf, win).astype(
            np.float32)).to(dev)
        fft = instance == "fft"
        geo = f"({nf}, {hop}, {win})"
        case(f"stft_{instance}", lambda: stft_cat(y, nf, hop, win),
             lambda: stft_cat_plain(y, nf, hop, win),
             lambda: torch.stft(y, nf, hop, window=window, center=True,
                                pad_mode="reflect", return_complex=True),
             BATCH * frames * (fft_instance_flops(nf, False) if fft
                               else fft_flops_per_frame(nf)),
             4.0 * (BATCH * CLIP + BATCH * frames * 2 * bins),
             f"{geo} (128, 28000) -> (128, {frames}, {2 * bins})", k1,
             None if fft else 2.0 * BATCH * frames * nf * 2 * bins)
        spec = stft_cat_plain(y, nf, hop, win)
        crm = (torch.rand(spec.shape, generator=gen) * 0.98 + 0.01).to(dev)
        clean = torch.complex(spec[..., :bins], spec[..., bins:]).transpose(1, 2)
        case(f"crm_istft_{instance}", lambda: crm_istft(crm, spec, nf, hop, win),
             lambda: crm_istft_plain(crm, spec, nf, hop, win),
             lambda: torch.istft(clean, nf, hop, window=window,
                                 center=True),
             BATCH * frames * (fft_instance_flops(nf, True) if fft
                               else fft_flops_per_frame(nf) + 20 * bins),
             4.0 * (2 * BATCH * frames * 2 * bins + BATCH * out_len),
             f"{geo} (128, {frames}, {2 * bins}) x 2 -> (128, {out_len})", k3,
             None if fft else 2.0 * BATCH * frames * 2 * bins * nf)

    def bucketed(instance, nf, hop, win, k1c, k3v):
        """K1 over pre-padded buffers of a 1,024-frame bucket (no
        reflect), K3 with a valid frame count per row on 16 rows"""
        bins, geo = nf // 2 + 1, f"({nf}, {hop}, {win})"
        fft = instance == "fft"
        window = torch.from_numpy(padded_window(nf, win).astype(np.float32)).to(dev)
        buf = (y if not fft else (torch.randn(
            BATCH, (BUCKET_FRAMES - 1) * hop + nf, generator=gen) * 0.3).to(dev))
        frames = stft_num_frames(buf.shape[1], nf, hop, center=False)
        case(f"stft_{instance}_center_false",
             lambda: stft_cat(buf, nf, hop, win, center=False),
             lambda: stft_cat_plain(buf, nf, hop, win, center=False),
             lambda: torch.stft(buf, nf, hop, window=window, center=False,
                                return_complex=True),
             BATCH * frames * (fft_instance_flops(nf, False) if fft
                               else fft_flops_per_frame(nf)),
             4.0 * (BATCH * buf.shape[1] + BATCH * frames * 2 * bins),
             f"{geo} (128, {buf.shape[1]}) -> (128, {frames}, {2 * bins})",
             k1c, None if fft else 2.0 * BATCH * frames * nf * 2 * bins)
        del buf
        rows_v = EVAL_BATCH * 2
        spec = stft_cat_plain((torch.randn(rows_v, (BUCKET_FRAMES - 1) * hop,
                                           generator=gen) * 0.3).to(dev),
                              nf, hop, win)
        crm = (torch.rand(spec.shape, generator=gen) * 0.98 + 0.01).to(dev)
        vt = torch.randint(2, BUCKET_FRAMES + 1, (rows_v,), generator=gen)
        vt[0], vt[1] = BUCKET_FRAMES, 2
        valid = int(vt.sum())
        vt = vt.to(dev)
        out_len = (BUCKET_FRAMES - 1) * hop + nf % 2
        compare = None if not fft else (
            lambda got, ref: within_valid(got, ref, vt, nf, hop, win, 1e-4,
                                          1e-4))
        case(f"crm_istft_{instance}_valid_t",
             lambda: crm_istft(crm, spec, nf, hop, win, valid_t=vt),
             lambda: crm_istft_plain(crm, spec, nf, hop, win, valid_t=vt),
             None,
             valid * (fft_instance_flops(nf, True) if fft
                      else fft_flops_per_frame(nf) + 20 * bins),
             4.0 * (2 * valid * 2 * bins + valid * hop),
             f"{geo} ({rows_v}, {BUCKET_FRAMES}, {2 * bins}) x 2, valid_t "
             f"2-{BUCKET_FRAMES} ({valid} valid frames) -> ({rows_v}, "
             f"{out_len})", k3v,
             None if fft else 2.0 * valid * 2 * bins * nf, compare)

    y = (torch.randn(BATCH, CLIP, generator=gen) * 0.3).to(dev)
    found = {}
    for nf, hop, win in FFT_GEOMETRIES:
        centered("fft", nf, hop, win, found.setdefault("stft_fft", {}),
                 found.setdefault("crm_istft_fft", {}))
    bucketed("fft", *FFT_BUCKETED, found.setdefault("stft_fft_center_false", {}),
             found.setdefault("crm_istft_fft_valid_t", {}))
    centered("generic", *GENERIC_GEOMETRY, found.setdefault("stft_generic", {}),
             found.setdefault("crm_istft_generic", {}))
    bucketed("generic", *GENERIC_GEOMETRY,
             found.setdefault("stft_generic_center_false", {}),
             found.setdefault("crm_istft_generic_valid_t", {}))
    sources = {"stft_fft": "stft_fft.cu", "crm_istft_fft": "crm_istft_fft.cu",
               "stft_generic": "stft_dense.cu",
               "crm_istft_generic": "crm_istft_dense.cu"}
    for name, r in found.items():
        kernel = name.replace("_center_false", "").replace("_valid_t", "")
        replaces = ("sos_tpu/dsp/stft.py:170" if name.endswith("_valid_t")
                    else "sos_tpu/dsp/stft.py:169" if name.startswith("crm")
                    else "sos_tpu/dsp/stft.py:139")
        record(name, f"sos_tpu_torch/csrc/{sources[kernel]}", replaces,
               r["err"], True, "atol 1e-4 + rtol 1e-4", r["ms"],
               r["plain_ms"], r["lib_ms"], r["flops"], r["bytes"],
               shape=" + ".join(r["shapes"]))


# the training path's BiLSTM shapes: (batch, steps, hidden) of the
# detector at batch 15 and the denoiser at batch 40
TRAIN_LSTM_SHAPES = ((15, 60, 100), (40, 178, 200))
# further training shapes, checked and logged beside the sum (which stays
# comparable with earlier runs): the joint step's denoiser at batch 15
TRAIN_LSTM_LOGGED = ((15, 178, 200),)


def cudnn_training_ms(xp_f, w_f, w_b, dev):
    """cuDNN's fp32 `nn.LSTM` (identity input weights, zero biases) in
    training: (forward, backward) ms of the recurrence alone. The
    forward records for autograd; the backward computes the data
    gradient only (the weights need none, as K4b computes none). Each
    less its two identity input projections (a matmul a direction
    forward, one a direction backward)."""
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
    lstm.requires_grad_(False)
    x = xp_f.detach().clone().requires_grad_(True)
    dy = torch.randn(*xp_f.shape[:2], 2 * hidden, device=dev)

    def forward():
        return lstm(x)[0]

    def forward_backward():
        forward().backward(dy)

    def projections():
        return torch.matmul(xp_f, eye), torch.matmul(xp_f, eye)
    with exact_fp32():
        fwd_ms = time_ms(forward)
        fb_ms = time_ms(forward_backward)
        proj_ms = time_ms(projections)
    return fwd_ms - proj_ms, fb_ms - fwd_ms - proj_ms


def training_cases(gen, dev, record):
    """The training path's kernel instances at its shapes: K4's training
    instance and K4b at the detector's (B 15, T 60, H 100) and the
    denoiser's (B 40, T 178, H 200) BiLSTM (summed in their rows), and
    the joint step's denoiser's (B 15, T 178, H 200, logged with its
    bound), and K2's complement at (15, 28000) and (40, 28000). K4's training instance: h bit-identical
    to the inference instance's, c and gates within 1e-6 of one step
    from the kernel's own state and within K4's 5e-5 of the plain
    training forward. K4b: against its plain version on the same saved
    state, 5e-5. Library: cuDNN `nn.LSTM` fp32 in training, forward and
    backward apart, less the identity projections."""
    acc = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "flops": 0.0,
               "bytes": 0.0, "err": 0.0, "ok": True}
           for k in ("train", "bwd")}
    floor_call, floor_sum = k4b_floor_calls(), 0.0
    for batch, steps, hidden in TRAIN_LSTM_SHAPES + TRAIN_LSTM_LOGGED:
        g4 = 4 * hidden
        xp_f, xp_b = (torch.randn(batch, steps, g4, generator=gen).to(dev)
                      for _ in range(2))
        bnd = 1.0 / hidden ** 0.5
        w_f, w_b = (((torch.rand(g4, hidden, generator=gen) * 2 - 1) * bnd)
                    .to(dev) for _ in range(2))
        out, c, gates = bilstm_recurrence_train(xp_f, xp_b, w_f, w_b)
        same_h = bool(torch.equal(out, bilstm_recurrence(xp_f, xp_b, w_f,
                                                         w_b)))
        with exact_fp32():
            plain = bilstm_recurrence_train_plain(xp_f, xp_b, w_f, w_b)
            step_c, step_g = bilstm_step_states(xp_f, xp_b, w_f, w_b, out,
                                                c)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in
                  zip((out, c, gates), plain))
        step_err_g = float((gates - step_g).abs().max())
        step_err_c = float(((c - step_c).abs()
                            / (1.0 + step_c.abs())).max())
        ok = (same_h and err <= 5e-5 and step_err_g <= 1e-6
              and step_err_c <= 1e-6)
        dout = torch.randn(batch, steps, 2 * hidden, generator=gen).to(dev)
        got = bilstm_recurrence_backward(dout, gates, c, w_f, w_b)
        with exact_fp32():
            ref = bilstm_recurrence_backward_plain(dout, gates, c, w_f, w_b)
        torch.cuda.synchronize()
        err_b = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        plan, bplan = recurrence_plan(batch, hidden), backward_plan(batch,
                                                                     hidden)
        ms = time_ms(lambda: bilstm_recurrence_train(xp_f, xp_b, w_f, w_b))
        b_ms = time_ms(lambda: bilstm_recurrence_backward(dout, gates, c,
                                                          w_f, w_b))
        floor_ms = time_ms(floor_call(bplan, dout, gates, c, w_f, w_b,
                                      torch.empty_like(gates)))
        with exact_fp32():
            plain_ms = time_ms(lambda: bilstm_recurrence_train_plain(
                xp_f, xp_b, w_f, w_b), reps=3, warmup=1)
            b_plain_ms = time_ms(lambda: bilstm_recurrence_backward_plain(
                dout, gates, c, w_f, w_b), reps=3, warmup=1)
        lib_f, lib_b = cudnn_training_ms(xp_f, w_f, w_b, dev)
        log(f"bilstm_train B{batch} T{steps}/H{hidden} (plan: "
            f"{k4_plan_note(plan)}): h bit-identical to the inference "
            f"instance {same_h}, max err against the plain training forward "
            f"{err:.3e} (tolerance 5e-5), one-step gates {step_err_g:.3e} "
            f"c {step_err_c:.3e} (tolerance 1e-6)  kernel {ms:.4f} ms "
            f"({ms / steps * 1e3:.2f} us/step)  plain {plain_ms:.4f} ms  "
            f"cuDNN training forward less projections {lib_f:.4f} ms")
        rec_flops = 2.0 * batch * steps * 2 * hidden * g4
        cases = (("train", (ms, plain_ms, lib_f, rec_flops
                            + 2.0 * batch * steps * 10 * hidden,
                            4.0 * (2 * batch * steps * g4 + 2 * g4 * hidden
                                   + batch * steps * 2 * hidden
                                   + 2 * batch * steps * (hidden + g4)),
                            err, ok)),
                 ("bwd", (b_ms, b_plain_ms, lib_b, rec_flops
                          + 2.0 * batch * steps * 20 * hidden,
                          4.0 * (batch * steps * 2 * hidden
                                 + 2 * batch * steps * (g4 + hidden)
                                 + 2 * g4 * hidden + 2 * batch * steps * g4),
                          err_b, err_b <= 5e-5)))
        b_bound, b_by = bound(*cases[1][1][3:5])
        log(f"bilstm_bwd B{batch} T{steps}/H{hidden} (plan: "
            f"{k4_plan_note(bplan)}): max err {err_b:.3e} (tolerance 5e-5)  "
            f"kernel {b_ms:.4f} ms ({b_ms / steps * 1e3:.2f} us/step)  "
            f"exchange-only floor {floor_ms:.4f} ms ("
            f"{floor_ms / steps * 1e3:.2f} us/step)  bound {b_bound:.4f} ms "
            f"({b_by})  plain {b_plain_ms:.4f} ms  cuDNN backward (data) "
            f"less projections {lib_b:.4f} ms")
        if (batch, steps, hidden) in TRAIN_LSTM_LOGGED:
            for key, vals in cases:
                bound_ms, bound_by = bound(vals[3], vals[4])
                log(f"  bilstm_{key} B{batch} T{steps}/H{hidden} (logged "
                    f"case): kernel {vals[0]:.4f} ms  bound {bound_ms:.4f} "
                    f"ms ({bound_by})  plain {vals[1]:.4f} ms  cuDNN "
                    f"{vals[2]:.4f} ms  max err {vals[5]:.3e} "
                    f"{'ok' if vals[6] else 'FAILED'}")
                if not vals[6]:
                    raise RuntimeError(f"bilstm_{key} B{batch} T{steps}/"
                                       f"H{hidden} disagrees with its plain "
                                       f"version")
            continue
        floor_sum += floor_ms
        for key, vals in cases:
            a = acc[key]
            for name, v in zip(("ms", "plain_ms", "library_ms", "flops",
                                "bytes"), vals[:5]):
                a[name] += v
            a["err"] = max(a["err"], vals[5])
            a["ok"] = a["ok"] and vals[6]
    shape = " + ".join(f"B{b} T{t}/H{h}" for b, t, h in TRAIN_LSTM_SHAPES)
    a = acc["train"]
    record("bilstm_train", "sos_tpu_torch/csrc/bilstm.cu",
           "sos_tpu/ops/lstm.py:28", a["err"], a["ok"],
           "h exact, c and gates 1e-6 a step, 5e-5 whole", a["ms"],
           a["plain_ms"], a["library_ms"], a["flops"], a["bytes"],
           shape=shape + " (sum)")
    a = acc["bwd"]
    log(f"bilstm_bwd {shape} (sum): exchange-only floor {floor_sum:.4f} ms")
    record("bilstm_bwd", "sos_tpu_torch/csrc/bilstm_bwd.cu",
           "sos_tpu/ops/lstm.py:28", a["err"], a["ok"], "atol 5e-5",
           a["ms"], a["plain_ms"], a["library_ms"], a["flops"], a["bytes"],
           shape=shape + " (sum)")

    ratio = 14000 / 30.0
    k2 = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "exact": True,
          "err": 0.0}
    for batch in (15, 40):
        y = (torch.randn(batch, CLIP, generator=gen) * 0.3).to(dev)
        bits = (torch.rand(batch, 60, generator=gen) < 0.5).float().to(dev)
        got = mask_gate(y, bits, ratio, complement=True)
        ref = mask_gate_plain(y, bits, ratio, complement=True)
        torch.cuda.synchronize()
        k2["exact"] = k2["exact"] and bool(torch.equal(got, ref))
        k2["err"] = max(k2["err"], float((got - ref).abs().max()))
        k2["ms"] += time_ms(lambda: mask_gate(y, bits, ratio, complement=True))
        k2["plain_ms"] += time_ms(lambda: mask_gate_plain(y, bits, ratio,
                                                          complement=True))
        k2["bytes"] += 4.0 * (2 * batch * CLIP + batch * 60 + CLIP)
    # 4 operations a sample as K2's row counts them, and the complement
    record("mask_gate_complement", "sos_tpu_torch/csrc/mask_gate.cu",
           "sos_tpu/dsp/mixing.py:285", k2["err"], k2["exact"], "exact",
           k2["ms"], k2["plain_ms"], None, 5.0 * 55 * CLIP, k2["bytes"],
           shape="x (15, 28000) + (40, 28000), bits (B, 60) -> x * (1 - mask)")


# K4's and K4b's wide route (past the register plans' H 224): (batch,
# steps, hidden), summed in the wide rows
WIDE_LSTM_SHAPES = ((16, 178, 256), (16, 178, 512))


def wide_plan_note(plan: WidePlan, train: bool = False) -> str:
    """A wide plan as phase 3 logs it: blocks, rows a task, rows and
    columns staged, shared bytes, and the blocks the card holds at once
    (a cooperative launch needs 2 x blocks of them)."""
    return (f"{plan.blocks} blocks a direction of {plan.threads} threads, "
            f"{plan.bt} rows a task, {plan.nr} rows x {plan.kc} columns "
            f"staged ({len(plan.chunks())} x {len(plan.column_chunks())} "
            f"stagings a step), {plan.smem_bytes} B shared; co-resident "
            f"blocks {coresident_blocks(plan, train)} for "
            f"{2 * plan.blocks}")


def wide_lstm_cases(gen, dev, record):
    """K4 (without and with per-row lengths), its training instance and
    K4b on the wide route at B 16, T 178, H 256 and H 512, against their
    plain versions at K4's and K4b's tolerances (5e-5; the training
    instance's h bit-identical to the inference instance's, c and gates
    within 1e-6 of one step from its own state), each beside cuDNN's fp32
    `nn.LSTM` at the same shape less its identity projections. Rows
    "bilstm_wide", "bilstm_train_wide", "bilstm_bwd_wide": the sums of
    the two shapes; the lengths case is checked and logged."""
    acc = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "flops": 0.0,
               "bytes": 0.0, "err": 0.0, "ok": True}
           for k in ("inf", "train", "bwd")}
    for batch, steps, hidden in WIDE_LSTM_SHAPES:
        g4 = 4 * hidden
        xp_f, xp_b = (torch.randn(batch, steps, g4, generator=gen).to(dev)
                      for _ in range(2))
        bnd = 1.0 / hidden ** 0.5
        w_f, w_b = (((torch.rand(g4, hidden, generator=gen) * 2 - 1) * bnd)
                    .to(dev) for _ in range(2))
        lengths = torch.randint(1, steps + 1, (batch,), generator=gen)
        lengths[0], lengths[1] = int(0.6 * steps), 1
        valid = int(lengths.sum())
        lengths = lengths.to(dev)
        plan, bplan = recurrence_plan(batch, hidden), backward_plan(batch,
                                                                     hidden)
        shape = f"B{batch} T{steps}/H{hidden}"
        # K4 wide, without and with lengths
        got = bilstm_recurrence(xp_f, xp_b, w_f, w_b)
        got_len = bilstm_recurrence(xp_f, xp_b, w_f, w_b, lengths)
        with exact_fp32():
            ref = bilstm_recurrence_plain(xp_f, xp_b, w_f, w_b)
            ref_len = bilstm_recurrence_plain(xp_f, xp_b, w_f, w_b, lengths)
        torch.cuda.synchronize()
        err, ok = within(got, ref, 5e-5, 0.0)
        err_len, ok_len = within(got_len, ref_len, 5e-5, 0.0)
        zeros = all(not bool(got_len[b, n:].any())
                    for b, n in enumerate(lengths.tolist()))
        ms = time_ms(lambda: bilstm_recurrence(xp_f, xp_b, w_f, w_b))
        len_ms = time_ms(lambda: bilstm_recurrence(xp_f, xp_b, w_f, w_b,
                                                   lengths))
        plain_ms = time_ms(lambda: bilstm_recurrence_plain(
            xp_f, xp_b, w_f, w_b), reps=3, warmup=1)
        fp32_ms, proj_ms, _ = cudnn_inference_ms(xp_f, w_f, w_b, dev)
        log(f"bilstm_wide {shape} (plan: {wide_plan_note(plan)}): max_abs_err "
            f"{err:.3e} (tolerance atol 5e-5) {'ok' if ok else 'FAILED'}  "
            f"kernel {ms:.4f} ms ({ms / steps * 1e3:.2f} us/step)  plain "
            f"{plain_ms:.4f} ms  cuDNN nn.LSTM fp32 less its projections "
            f"{fp32_ms - proj_ms:.4f} ms; with lengths (longest "
            f"{int(lengths.max())}, {valid} valid steps of "
            f"{batch * steps}): max_abs_err {err_len:.3e} "
            f"{'ok' if ok_len else 'FAILED'}, padding steps zero {zeros}, "
            f"kernel {len_ms:.4f} ms")
        if not (ok_len and zeros):
            raise RuntimeError(f"bilstm_lengths_wide {shape} disagrees with "
                               "its plain version")
        # the training instance and K4b
        out, c, gates = bilstm_recurrence_train(xp_f, xp_b, w_f, w_b)
        same_h = bool(torch.equal(out, got))
        with exact_fp32():
            plain = bilstm_recurrence_train_plain(xp_f, xp_b, w_f, w_b)
            step_c, step_g = bilstm_step_states(xp_f, xp_b, w_f, w_b, out, c)
        torch.cuda.synchronize()
        err_t = max(float((a - b).abs().max()) for a, b in
                    zip((out, c, gates), plain))
        step_err = max(float((gates - step_g).abs().max()),
                       float(((c - step_c).abs() / (1.0 + step_c.abs())).max()))
        ok_t = same_h and err_t <= 5e-5 and step_err <= 1e-6
        dout = torch.randn(batch, steps, 2 * hidden, generator=gen).to(dev)
        dxp = bilstm_recurrence_backward(dout, gates, c, w_f, w_b)
        with exact_fp32():
            ref_b = bilstm_recurrence_backward_plain(dout, gates, c, w_f, w_b)
        torch.cuda.synchronize()
        err_b = max(float((a - b).abs().max()) for a, b in zip(dxp, ref_b))
        t_ms = time_ms(lambda: bilstm_recurrence_train(xp_f, xp_b, w_f, w_b))
        b_ms = time_ms(lambda: bilstm_recurrence_backward(dout, gates, c,
                                                          w_f, w_b))
        with exact_fp32():
            t_plain = time_ms(lambda: bilstm_recurrence_train_plain(
                xp_f, xp_b, w_f, w_b), reps=3, warmup=1)
            b_plain = time_ms(lambda: bilstm_recurrence_backward_plain(
                dout, gates, c, w_f, w_b), reps=3, warmup=1)
        lib_f, lib_b = cudnn_training_ms(xp_f, w_f, w_b, dev)
        log(f"bilstm_train_wide {shape}: h bit-identical to the inference "
            f"instance {same_h}, max err against the plain training forward "
            f"{err_t:.3e} (tolerance 5e-5), one step {step_err:.3e} "
            f"(tolerance 1e-6)  kernel {t_ms:.4f} ms  plain {t_plain:.4f} "
            f"ms  cuDNN training forward less projections {lib_f:.4f} ms")
        log(f"bilstm_bwd_wide {shape} (plan: {wide_plan_note(bplan)}): max "
            f"err {err_b:.3e} (tolerance 5e-5)  kernel {b_ms:.4f} ms "
            f"({b_ms / steps * 1e3:.2f} us/step)  plain {b_plain:.4f} ms  "
            f"cuDNN backward (data) less projections {lib_b:.4f} ms")
        rec_flops = 2.0 * batch * steps * 2 * hidden * g4
        io = 2 * batch * steps * g4 + 2 * g4 * hidden
        for key, vals in (
                ("inf", (ms, plain_ms, fp32_ms - proj_ms,
                         rec_flops + 2.0 * batch * steps * 10 * hidden,
                         4.0 * (io + batch * steps * 2 * hidden), err, ok)),
                ("train", (t_ms, t_plain, lib_f,
                           rec_flops + 2.0 * batch * steps * 10 * hidden,
                           4.0 * (io + batch * steps * 2 * hidden
                                  + 2 * batch * steps * (hidden + g4)),
                           err_t, ok_t)),
                ("bwd", (b_ms, b_plain, lib_b,
                         rec_flops + 2.0 * batch * steps * 20 * hidden,
                         4.0 * (batch * steps * 2 * hidden
                                + 2 * batch * steps * (g4 + hidden)
                                + 2 * g4 * hidden + 2 * batch * steps * g4),
                         err_b, err_b <= 5e-5))):
            a = acc[key]
            for name, v in zip(("ms", "plain_ms", "library_ms", "flops",
                                "bytes"), vals[:5]):
                a[name] += v
            a["err"] = max(a["err"], vals[5])
            a["ok"] = a["ok"] and vals[6]
    shape = " + ".join(f"B{b} T{t}/H{h}" for b, t, h in WIDE_LSTM_SHAPES)
    for key, name, source, tol in (
            ("inf", "bilstm_wide", "sos_tpu_torch/csrc/bilstm_wide.cu",
             "atol 5e-5"),
            ("train", "bilstm_train_wide", "sos_tpu_torch/csrc/bilstm_wide.cu",
             "h exact, c and gates 1e-6 a step, 5e-5 whole"),
            ("bwd", "bilstm_bwd_wide", "sos_tpu_torch/csrc/bilstm_wide.cu",
             "atol 5e-5")):
        a = acc[key]
        record(name, source, "sos_tpu/ops/lstm.py:28", a["err"], a["ok"],
               tol, a["ms"], a["plain_ms"], a["library_ms"], a["flops"],
               a["bytes"], shape=shape + " (sum)")


# K2's windows past the dense matrices' 2^24 elements (the gather maps'
# table; 600 s is 18,000 frames, past the former shared-memory limit of
# 7,264) and its generic despeckle (`despeckle_min_run` 600 > the frame
# body of ~466 samples): (rows, seconds, min_run, complement)
K2_LONG_CASES = ((8, 60, 5, False), (8, 60, 5, True), (2, 600, 5, False),
                 (2, 600, 5, True))
K2_DESPECKLE_CASES = ((16, 2, 600, False), (16, 2, 600, True),
                      (8, 8, 600, False), (8, 8, 600, True))


def k2_window_cases(gen, dev, record):
    """K2's long-window and generic-despeckle cases against their plain
    versions, exactly; one row each (the sum of its cases). Bound: bytes,
    the samples read and written once, the bits, and the geometry table
    (a word a sample and a frame range a 256-sample chunk)."""
    ratio = 14000 / 30.0
    for name, cases in (("mask_gate_long", K2_LONG_CASES),
                        ("mask_gate_despeckle", K2_DESPECKLE_CASES)):
        acc = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "ops": 0.0,
               "exact": True, "err": 0.0}
        shapes = []
        for rows, seconds, min_run, comp in cases:
            length, frames = seconds * 14000, seconds * 30
            y = (torch.randn(rows, length, generator=gen) * 0.3).to(dev)
            bits = (torch.rand(rows, frames, generator=gen) < 0.5).float().to(dev)
            if min_run > 5:  # runs of 1-3 frames: short and long runs
                reps = torch.randint(1, 4, (frames,), generator=gen)
                bits = bits.repeat_interleave(reps.to(dev), dim=1)[:, :frames]
            before = LAUNCHES[name]
            got = mask_gate(y, bits, ratio, min_run, complement=comp)
            ref = mask_gate_plain(y, bits, ratio, min_run, complement=comp)
            torch.cuda.synchronize()
            if LAUNCHES[name] != before + 1:
                raise RuntimeError(f"{name}: the call did not launch its case")
            exact = bool(torch.equal(got, ref))
            err = float((got - ref).abs().max())
            ms = time_ms(lambda: mask_gate(y, bits, ratio, min_run,
                                           complement=comp))
            plain_ms = time_ms(lambda: mask_gate_plain(
                y, bits, ratio, min_run, complement=comp), reps=5, warmup=1)
            nbytes = 4.0 * (2 * rows * length + rows * frames + length) \
                + 8.0 * -(-length // 256)
            bound_ms = bound(4.0 * rows * length, nbytes)[0]
            log(f"{name} {rows} x {seconds} s ({frames} frames, {length} "
                f"samples, min_run {min_run}, "
                f"{'complement' if comp else 'gate'}): exact {exact}  "
                f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound "
                f"{bound_ms:.4f} ms (bytes)")
            acc["ms"] += ms
            acc["plain_ms"] += plain_ms
            acc["bytes"] += nbytes
            acc["ops"] += 4.0 * rows * length
            acc["exact"] = acc["exact"] and exact
            acc["err"] = max(acc["err"], err)
            shapes.append(f"{rows}x{seconds}s{' 1-mask' if comp else ''}")
        record(name, "sos_tpu_torch/csrc/mask_gate.cu",
               "sos_tpu/dsp/mixing.py:271" if name == "mask_gate_long"
               else "sos_tpu/dsp/mixing.py:312", acc["err"], acc["exact"],
               "exact", acc["ms"], acc["plain_ms"], None, acc["ops"],
               acc["bytes"],
               shape=" + ".join(shapes) + (" (min_run 600)" if "despeckle"
                                            in name else "") + " (sum)")


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


# K4 with per-row lengths in phase 3: (batch, T, H, longest row as a share
# of T). The B 16 cases are summed in the kernels line; the B 8 ones (the
# eval chain's batch, longest row at 0.6 T) are checked and logged
K4_LENGTHS_CASES = ((16, 1024, 200, 1.0), (16, 384, 100, 1.0),
                    (8, 1024, 200, 0.6), (8, 384, 100, 0.6))


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
    zero_ok, zero_n = zeros_past_reach(got, valid_t, nf, hop)
    ok = ok and zero_ok
    log(f"crm_istft_valid_t: max_abs_err over the kept samples "
        f"{kept:.3e}; exactly 0 on the {zero_n} samples past the rows' live "
        f"reach {zero_ok}; valid frames {frames_in} of {rows * bucket}; "
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
    # the B 8 cases draw from a generator of their own: the later phases
    # keep the weights and data they were validated on (drawn from `gen`)
    gen8 = torch.Generator().manual_seed(SEED + 5)
    for batch, steps, hidden, top in K4_LENGTHS_CASES:
        g = gen if batch == rows else gen8
        g4 = 4 * hidden
        xp_f = torch.randn(batch, steps, g4, generator=g).to(dev)
        xp_b = torch.randn(batch, steps, g4, generator=g).to(dev)
        bnd = 1.0 / hidden ** 0.5
        w_f = ((torch.rand(g4, hidden, generator=g) * 2 - 1) * bnd).to(dev)
        w_b = ((torch.rand(g4, hidden, generator=g) * 2 - 1) * bnd).to(dev)
        longest = int(top * steps)
        lengths = torch.randint(1, longest + 1, (batch,), generator=g)
        lengths[0] = longest
        valid = int(lengths.sum())
        lengths = lengths.to(dev)
        got = bilstm_recurrence(xp_f, xp_b, w_f, w_b, lengths)
        ref = bilstm_recurrence_plain(xp_f, xp_b, w_f, w_b, lengths)
        torch.cuda.synchronize()
        err, ok = within(got, ref, 5e-5, 0.0)
        zeros = all(not bool(got[b, n:].any())
                    for b, n in enumerate(lengths.tolist()))
        ms = time_ms(lambda: bilstm_recurrence(xp_f, xp_b, w_f, w_b, lengths))
        plan = recurrence_plan(batch, hidden)
        note = (f"bilstm_lengths T{steps}/H{hidden}, {batch} rows, longest "
                f"{longest}, {valid} valid steps of {batch * steps}: "
                f"max_abs_err {err:.3e} (tolerance atol 5e-5) "
                f"{'ok' if ok else 'FAILED'}, padding steps zero {zeros}; "
                f"kernel {ms:.4f} ms ({ms / longest * 1e3:.2f} us a step of "
                f"the longest row); plan {k4_plan_note(plan)}")
        if batch != rows:
            log(note)
            if not (ok and zeros):
                raise RuntimeError(f"bilstm_lengths B{batch} T{steps}/"
                                   f"H{hidden} disagrees with its plain "
                                   "version")
            continue
        plain_ms = time_ms(lambda: bilstm_recurrence_plain(
            xp_f, xp_b, w_f, w_b, lengths), reps=2, warmup=1)
        lib_ms = lstm_library_ms(xp_f, w_f, w_b, lengths, dev)
        flops = 2.0 * valid * (2 * hidden * g4 + 10 * hidden)
        nbytes = 4.0 * (2 * valid * g4 + 2 * g4 * hidden
                        + rows * steps * 2 * hidden + rows)
        log(f"{note}  plain {plain_ms:.4f} ms  cuDNN packed fp32 recurrence "
            f"{lib_ms:.4f} ms")
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
# first runs on the first-layer kernel, the middle two on the tile, the
# last on the projection kernel (the routes of `conv_same_route`)
K6_CASES = (
    ("enc_x block 0 2->96 1x7", 2, 96, (1, 7), (1, 1), 256, 178, False),
    ("enc_x block 7 96->96 5x5 d(32,1)", 96, 96, (5, 5), (32, 1), 256, 178,
     False),
    ("detector block 10 48->48 5x5 d(4,4)", 48, 48, (5, 5), (4, 4), 256, 178,
     False),
    ("enc_x proj 96->8 1x1 float32 out", 96, 8, (1, 1), (1, 1), 256, 178,
     True),
)
# K6's first-layer and projection kernels at every first-layer and
# projection shape of the int8 main path (enc_n's block 0 is the
# detector's; the detector's proj runs on its 60 frames after time_take)
K6_FIRST_CASES = (
    ("detector/enc_n block 0 2->48 1x7", 2, 48, (1, 7), (1, 1), 256, 178,
     False),
    ("enc_x block 0 2->96 1x7", 2, 96, (1, 7), (1, 1), 256, 178, False),
)
K6_PROJ_CASES = (
    ("enc_x proj 96->8 1x1 float32 out", 96, 8, (1, 1), (1, 1), 256, 178,
     True),
    ("enc_n proj 48->4 1x1 float32 out", 48, 4, (1, 1), (1, 1), 256, 178,
     True),
    ("detector proj 48->8 1x1 float32 out at 60 frames", 48, 8, (1, 1),
     (1, 1), 256, 60, True),
)
# further K6 cases, checked and logged beside the sum (which stays
# comparable with earlier runs): the widest halo, then the mma.sync
# gather's two loaders and two epilogues at shapes no full-width model
# routes elsewhere (a narrow first layer, a 1x1 with int8 out, a narrow
# float projection)
K6_LOGGED_CASES = (
    ("enc_x block 13 96->96 5x5 d(32,32)", 96, 96, (5, 5), (32, 32), 256,
     178, False),
    ("narrow block 0 2->8 1x7", 2, 8, (1, 7), (1, 1), 256, 178, False),
    ("1x1 48->8 int8 out", 48, 8, (1, 1), (1, 1), 256, 178, False),
    ("narrow proj 16->8 1x1 float32 out", 16, 8, (1, 1), (1, 1), 256, 178,
     True),
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


# K6 and K7 with per-row valid widths, at phase 7's largest bucket (1,024
# frames; InpaintNet widths 1,024 / 512 / 256)
K6_VALID_CASES = (
    ("enc_x block 0 2->96 1x7", 2, 96, (1, 7), (1, 1), 256, 1024, False),
    ("enc_x block 7 96->96 5x5 d(32,1)", 96, 96, (5, 5), (32, 1), 256, 1024,
     False),
)
K7_VALID_CASES = (
    ("a_in 2->64 k5", "down", 5, 1, 1, 2, 64, 256, 1024),
    ("a_d1 64->128 k5 s2", "down", 5, 2, 1, 64, 128, 256, 1024),
    ("mid_dil16 256->256 k3 d16", "down", 3, 1, 16, 256, 256, 64, 256),
    ("mid_up 256->128 k3 s2 transposed", "up", 3, 2, 1, 256, 128, 64, 256),
)
# K7 without valid_t at the same widths: the exact mode's long rows, in
# segments on the tile (checked and logged)
K7_LONG_CASES = tuple((f"{c[0]} W {c[-1]}",) + c[1:] for c in K7_VALID_CASES)
# K7 on a short row: the mid_dil16 block of a 0.5 s utterance (45
# frames, 12 columns after the two stride-2 blocks), whose reflect pad
# 16 reaches past the row (checked and logged)
K7_SHORT_CASES = (
    ("mid_dil16 256->256 k3 d16 short row W 12", "down", 3, 1, 16, 256, 256,
     64, 12),
)


def valid_widths(batch: int, width: int, gen: torch.Generator,
                 dev: torch.device) -> torch.Tensor:
    """Per-row valid widths over 2 .. width, the first row full."""
    vt = torch.randint(2, width + 1, (batch,), generator=gen, device=dev)
    vt[0] = width
    return vt


def int8_conv_case(kernel: str, case, gen: torch.Generator,
                   dev: torch.device, batch: int = BATCH,
                   valid: bool = False):
    """One K6 or K7 shape at `batch` rows: exact against the plain
    version, then kernel, plain and (for context) cuDNN bf16 conv times.
    Bound counts the real multiply-adds (for the transposed conv, not the
    inserted zeros) at the int8 peak. `valid`: per-row valid widths over
    2 .. W (the first row W), the input random past them too; the bound
    then counts the valid output positions' operations and the valid
    input's bytes."""
    out_f32, route = False, "mma.sync gather"
    vt = None
    library = None
    entry = None  # K6: the entry point its route must launch
    if kernel == "int8_conv":
        label, cin, cout, ks, dil, h, w, out_f32 = case
        kh, kw = ks
        k6_route = conv_same_route(w, cin, cout, ks, dil, out_f32)
        route, entry = K6_ROUTE_LABELS[k6_route], K6_ROUTE_ENTRIES[k6_route]
        ho, wo = h, w
        if valid:
            vt = valid_widths(batch, w, gen, dev)
            v_in = v_out = int(vt.sum())
        else:
            v_in = v_out = batch * w
        ops = 2.0 * ho * v_out * cout * kh * kw * cin

        def call(x, fn, widths):
            return fn(x, wq, ws, b, ks, dil, out_f32, valid_t=widths)

        fns = (conv_same_int8, conv_same_int8_plain)
        if k6_route == "proj" and not valid:
            library = int_mm_projection
        pads = ((kh - 1) // 2 * dil[0], (kw - 1) // 2 * dil[1])
        ctx = lambda: torch.nn.functional.conv2d(  # noqa: E731
            xb, wb, padding=pads, dilation=dil)
    else:
        label, kind, k, st, d, cin, cout, h, w = case
        kh = kw = k
        prepad = needs_prepad(kind, k, d, h, w)
        if prepad:  # the wrapper pads by a gather, then K7 with pad 0
            pp = (k - 1) // 2 * d
            plan = inpaint_plan(kind, k, st, d, h + 2 * pp, w + 2 * pp, cin,
                                cout, 0)
        else:
            plan = inpaint_plan(kind, k, st, d, h, w, cin, cout)
        prefix = "reflect_prepad gather, pad 0: " if prepad else ""
        route = prefix + route
        if plan is not None:
            route = prefix + (
                     f"wgmma halo tile, {len(plan.phases)} phase(s), "
                     f"{plan.rows} row(s) x pitch {plan.pitch}, "
                     f"{plan.nseg} segment(s) of {plan.seg_len} in "
                     f"{plan.mt} m64 ({plan.m_share():.3f} of m rows used), "
                     f"n {plan.n} x {plan.n_tiles}, {plan.groups} channel "
                     f"group(s) a tap; L2->SM "
                     f"{plan.tile_bytes(batch) / 1e9:.3f} GB, gather "
                     f"{plan.gather_bytes(batch, h, w, cin) / 1e9:.3f} GB")
        if valid:
            vt = valid_widths(batch, w, gen, dev)
            v_in = int(vt.sum())
            v_out = int(inpaint_valid_out(kind, k, st, d, vt).clamp(
                max=inpaint_valid_out(kind, k, st, d, w)).sum())
        if kind == "down":
            pad = (k - 1) // 2 * d
            ho, wo = ((n + 2 * pad - d * (k - 1) - 1) // st + 1 for n in (h, w))
            if not valid:
                v_in, v_out = batch * w, batch * wo
            ops = 2.0 * ho * v_out * cout * k * k * cin
            ctx = lambda: torch.nn.functional.conv2d(  # noqa: E731
                xb, wb, stride=st, padding=pad, dilation=d)
        else:
            lo, hi = up_pads(k)
            ho, wo = ((n - 1) * st + lo + hi - k + 2 for n in (h, w))
            if not valid:
                v_in = v_out = batch * w
            ops = 2.0 * h * v_in * cout * k * k * cin
            ctx = lambda: torch.nn.functional.conv_transpose2d(  # noqa: E731
                xb, wb.transpose(0, 1), stride=st, padding=(k - 1) // 2,
                output_padding=1)
        alpha = torch.tensor([0.25], device=dev)

        def call(x, fn, widths):
            return fn(x, wq, ws, b, alpha, kind, k, st, d, valid_t=widths)

        fns = (inpaint_conv_int8, inpaint_conv_int8_plain)
    run = lambda x: call(x, fns[0], vt)  # noqa: E731
    plain = lambda x: call(x, fns[1], vt)  # noqa: E731
    taps_cin = kh * kw * cin
    kpad = -(-taps_cin // 64) * 64
    wq = torch.randint(-127, 128, (cout, kpad), generator=gen, device=dev,
                       dtype=torch.int8)
    wq[:, taps_cin:] = 0
    ws = (torch.rand(cout, generator=gen, device=dev) + 0.5) * 0.01 \
        / taps_cin ** 0.5
    b = torch.randn(cout, generator=gen, device=dev) * 20
    x = torch.randint(-127, 128, (batch, h, w, cin), generator=gen,
                      device=dev, dtype=torch.int8)
    before = ENTRY_LAUNCHES[entry] if entry else 0
    got, ref = run(x), plain(x)
    torch.cuda.synchronize()
    if entry and ENTRY_LAUNCHES[entry] != before + 1:
        raise RuntimeError(f"{kernel} {label}: {entry} launched "
                           f"{ENTRY_LAUNCHES[entry] - before} times, not 1")
    exact = bool(torch.equal(got, ref))
    err = float((got.float() - ref.float()).abs().max())
    if vt is not None:  # zeros past each row's valid output width
        width = got.shape[2]
        v_rows = (vt if kernel == "int8_conv"
                  else inpaint_valid_out(kind, k, st, d, vt))
        exact = exact and not any(
            bool(got[r, :, min(v, width):].any())
            for r, v in enumerate(v_rows.tolist()))
    del got, ref
    ms = time_ms(lambda: run(x))
    masked = {}
    if vt is not None:
        masked = masked_costs(kernel, case, call, fns, x, vt)
        exact = exact and masked["full_exact"]
    plain_ms = time_ms(lambda: plain(x), reps=1, warmup=0)
    xb = x.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    wb = torch.randn(cout, cin, kh, kw, generator=gen, device=dev).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    ctx_ms = time_ms(ctx)
    del xb, wb
    lib = {} if library is None else library(x, wq, ws, b, ref_fn=plain)
    nbytes = float(h * v_in * cin
                   + batch * ho * wo * cout * (4 if out_f32 else 1)
                   + cout * kpad + 8 * cout + (8 * batch if valid else 0))
    bound_ms, by = bound(ops, nbytes, PEAK_INT8_OPS)
    tag = (f", valid_t {v_in} of {batch * w} input columns"
           if valid else "")
    if masked:
        share = masked["live_share"]
        tag += ("; masked instance: live items "
                + ("n/a (no segments)" if share is None else
                   f"{share:.4f} (aim {share * masked['unmasked_ms']:.4f} ms "
                   f"+ 15 %)")
                + f", every row full {masked['full_ms']:.4f} ms (exact "
                f"{masked['full_exact']}), unmasked instance "
                f"{masked['unmasked_ms']:.4f} ms")
    log(f"{kernel} {label} [{route}]: ({batch}, {h}, {w}, {cin}) -> "
        f"({batch}, {ho}, {wo}, {cout}){tag}; exact {exact} (max |err| "
        f"{err:.3e})  kernel {ms:.4f} ms ({ops / ms / 1e9:.1f} TOPS)  plain "
        f"{plain_ms:.4f} ms  bound {bound_ms:.4f} ms ({by})  cuDNN bf16 conv "
        f"at this shape (context, not the same function) {ctx_ms:.4f} ms"
        + ("" if not lib else
           f"  torch._int_mm + epilogue {lib['library_ms']:.4f} ms "
           f"(torch._int_mm alone {lib['int_mm_ms']:.4f} ms; same result "
           f"{lib['equal']})"))
    if not exact:
        raise RuntimeError(f"{kernel} {label}: kernel disagrees with its "
                           "plain version")
    return {"ms": ms, "plain_ms": plain_ms, "ops": ops, "bytes": nbytes,
            "err": err, "exact": exact, **lib, **masked}


def masked_costs(kernel: str, case, call, fns, x, vt):
    """What a K6 or K7 valid-width case's masked instance skips and costs
    (`call(x, fn, widths)` runs the case's block through `fn`, `fns` the
    wrapper and its plain version): the share of its items that it
    computes at the widths `vt` (`HaloPlan.live_share` /
    `InpaintPlan.live_share`; None on a route without segments), its
    time with every row full (checked exactly) and the unmasked
    instance's time on the same input."""
    w = x.shape[2]
    if kernel == "int8_conv":
        _, cin, cout, ks, dil, _, _, _ = case
        plan = halo_plan(w, cin, cout, tuple(ks), tuple(dil))
        share = None if plan is None else plan.live_share(vt.tolist(), w)
    else:
        _, kind, k, st, d, cin, cout, h, _ = case
        plan = inpaint_plan(kind, k, st, d, h, w, cin, cout)
        share = plan.live_share(
            inpaint_valid_out(kind, k, st, d, vt).tolist())
    full = torch.full_like(vt, w)
    full_exact = bool(torch.equal(call(x, fns[0], full),
                                  call(x, fns[1], full)))
    return {"live_share": share, "full_exact": full_exact,
            "full_ms": time_ms(lambda: call(x, fns[0], full)),
            "unmasked_ms": time_ms(lambda: call(x, fns[0], None))}


K6_ROUTE_LABELS = {"tile": "wgmma halo tile",
                   "first": "first-layer kernel",
                   "proj": "projection kernel",
                   "gather": "mma.sync gather"}
K6_ROUTE_ENTRIES = {"tile": "sos_int8_conv_same_halo",
                    "first": "sos_int8_conv_first",
                    "proj": "sos_int8_conv_proj",
                    "gather": "sos_int8_conv_same"}


def int_mm_projection(x, wq, ws, b, ref_fn):
    """K6's 1x1 float32 projection as PyTorch calls, its library
    yardstick: `torch._int_mm` of the (positions, Cin) input by the
    weights padded to 8 columns (cuBLASLt's least width), then the
    dequant and ReLU as torch ops on the Cout columns. Returns its ms,
    `_int_mm`'s alone and whether it equals `ref_fn(x)` (the plain
    version) bit for bit."""
    cin, cout = x.shape[-1], wq.shape[0]
    a = x.reshape(-1, cin)
    wt = torch.zeros(8, cin, dtype=torch.int8, device=x.device)
    wt[:cout] = wq[:, :cin]
    bt = wt.t()  # (Cin, 8), column-major, as cuBLASLt wants it

    def call():
        acc = torch._int_mm(a, bt)
        return torch.clamp_min(acc[:, :cout].float() * ws + b, 0.0)

    got = call().reshape(*x.shape[:-1], cout)
    equal = bool(torch.equal(got, ref_fn(x)))
    del got
    return {"library_ms": time_ms(call),
            "int_mm_ms": time_ms(lambda: torch._int_mm(a, bt)),
            "equal": equal}


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


# the bucketed cases the eval chain (phase 7) must launch, in f32 and
# (K6, K7) in int8
EVAL_KERNELS = ("stft_center_false", "crm_istft_valid_t", "bilstm_lengths")
INT8_EVAL_KERNELS = ("int8_conv_valid_t", "int8_inpaint_valid_t")

MAIN_PATH_KERNELS = {
    "f32": ("stft", "mask_gate", "crm_istft", "bilstm"),
    "int8": ("stft", "mask_gate", "crm_istft", "bilstm", "int8_conv",
             "int8_inpaint"),
}
# K6's C entry points an int8 pipeline call launches, by phase 3's
# record, and how often: the first layers and projections of the
# detector trunk and both encoders; the other K6 blocks on the tile
INT8_K6_ENTRIES = {"int8_conv_first": ("sos_int8_conv_first", 3),
                   "int8_conv_proj": ("sos_int8_conv_proj", 3)}


def k6_entry_launches(label: str) -> dict:
    """The int8 pipeline call just run launched K6's first-layer and
    projection kernels 3 times each and its `mma.sync` gather never
    (else raise); their counts by phase 3's record."""
    got = {name: ENTRY_LAUNCHES[entry]
           for name, (entry, _) in INT8_K6_ENTRIES.items()}
    want = {name: n for name, (_, n) in INT8_K6_ENTRIES.items()}
    gather = ENTRY_LAUNCHES["sos_int8_conv_same"]
    log(f"{label}: K6 launches first layer {got['int8_conv_first']}, "
        f"projection {got['int8_conv_proj']}, tile "
        f"{ENTRY_LAUNCHES['sos_int8_conv_same_halo']}, gather {gather}")
    if got != want or gather:
        raise RuntimeError(f"{label}: K6 launched {got} and the gather "
                           f"{gather} times, not {want} and 0")
    return got


def phase_main_path(cfg: ExperimentConfig, det_state, den_state,
                    gen: torch.Generator, profile: str, workdir: str,
                    clips: int = 2, kernels=None, label: str = "",
                    scale_file: str = "int8_calibration.json"):
    """Full-width pipeline on 2 clips: card vs CPU, launch counts. The
    int8 profile calibrates on the CPU, which writes the scale file
    `workdir/int8_calibration.json` that the card pipeline (and the
    serving phase) then loads, so all run the same scales. Phase 13 runs
    it at other widths: `clips`, the `kernels` that must launch (else
    MAIN_PATH_KERNELS, with K6's main-path routes checked), a `label`
    and a scale file of their own."""
    x = make_clips(clips, gen)
    path = os.path.join(workdir, scale_file)
    name = f"{profile}{label}"
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
    log(f"main path {name} launches: {launches}")
    if profile == "int8" and kernels is None:
        launches.update(k6_entry_launches(f"main path {profile}"))
    missing = [k for k in kernels or MAIN_PATH_KERNELS[profile]
               if launches[k] == 0]
    if missing:
        raise RuntimeError(f"main path {name} never launched: {missing}")

    y_host, bits_host = host(x)
    margin = (prob - threshold).abs()
    clear = margin > 1e-3
    bits_card = bits_card.cpu()
    if not torch.equal(bits_card[clear], bits_host[clear]):
        raise RuntimeError(f"main path {name}: card and CPU bits differ "
                           "off the threshold")
    if torch.equal(bits_card, bits_host):
        y_cmp = y_card.cpu()
    else:  # a frame within 1e-3 of the threshold flipped: same bits then
        y_cmp = card.denoise_with_bits(x, bits_host).cpu()
    diff = float((y_cmp - y_host).abs().max())
    finite = bool(torch.isfinite(y_card).all())
    voiced = int(bits_host.sum())
    log(f"main path {name} ({clips} clips): waveform "
        f"{tuple(y_card.shape)} finite {finite}, max |card - cpu| "
        f"{diff:.3e} (tolerance 1e-3), threshold {threshold:.6f}, bits "
        f"voiced {voiced}/{bits_host.numel()}, min margin "
        f"{float(margin.min()):.3e}, bits equal "
        f"{bool(torch.equal(bits_card, bits_host))}")
    if (not finite or tuple(y_card.shape) != (clips, 27966)
            or not diff <= 1e-3):
        raise RuntimeError(f"main path {name}: card output disagrees "
                           "with the CPU")
    return launches


# device-time categories of one pipeline call, matched on kernel names
# in this order (cuDNN's FFT convolutions run pointwise_mult_and_sum)
CATEGORIES = (
    ("K5 int8_gemm", ("gemm_tma_s8",)),
    ("K7 int8_inpaint", ("inpaint_halo_s8", "InpaintPad>")),
    ("K7 int8_inpaint's gather (W reflect, phases)", ("inpaint_gather_s8",)),
    ("K6 int8_conv tile", ("conv_halo_s8",)),
    ("K6 int8_conv first layer", ("conv_first_s8",)),
    ("K6 int8_conv projection", ("conv_proj_s8",)),
    ("K6 int8_conv igemm_s8 gather", ("SamePad>",)),
    ("K1 stft", ("stft_analysis_pfa",)),
    ("K3 crm_istft", ("crm_synthesis_pfa",)),
    ("K2 mask_gate", ("mask_gate_kernel",)),
    ("K4 bilstm", ("bilstm_kernel",)),
    ("elementwise (BN, activations, casts, copies)",
     ("elementwise_kernel", "copy_kernel", "CatArrayBatchedCopy")),
    ("convolutions", ("conv", "cudnn", "fprop", "dgrad", "winograd",
                      "implicit", "fft", "pointwise_mult_and_sum", "Nchw",
                      "nchw", "Nhwc", "nhwc")),
    ("matmuls", ("gemm", "Gemm", "cutlass", "cublas")),
)


def _category(name: str, categories) -> str:
    for label, keys in categories:
        if any(k in name for k in keys):
            return label
    return "other"


def profile_call(fn, categories=CATEGORIES):
    """Device time of one call of `fn` by kernel category, from
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
        label = _category(name, categories)
        cats[label] = cats.get(label, 0.0) + ms
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
        reset_launches()
        prof = profile_call(lambda: pipe(x))
        if profile == "int8":
            k6_entry_launches("throughput int8, the profiled call")
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


def bucket_fill(pred, wavs, frames=None) -> str:
    """The bucketed chain's fill: the utterances' STFT frames over the
    frames its tiles of EVAL_BATCH rows compute (each tile a bucket wide,
    short tiles filled with repeated rows), grouped as `pred`'s
    `predict_batch` (by bucket and frame bucket; `frames` given) or
    `denoise_batch` (by bucket) groups them."""
    hop = pred.cfg.stft.hop_length
    groups = {}
    for i, w in enumerate(wavs):
        key = (pred._bucket_t(1 + len(w) // hop),
               None if frames is None else pred._frames_bucket(frames[i]))
        groups.setdefault(key, []).append(1 + len(w) // hop)
    valid = sum(sum(v) for v in groups.values())
    tiles = sum(-(-len(v) // EVAL_BATCH) * EVAL_BATCH * key[0]
                for key, v in groups.items())
    return f"{valid / tiles:.4f} ({valid} of {tiles} frames)"


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
    # int8 loads phase 4's scale file (written once on the CPU)
    calib = {"calibration_path": os.path.join(workdir,
                                              "int8_calibration.json")}
    results, int8_launches = {}, {}
    t_int8 = 0.0
    for profile in ("f32", "bf16", "int8"):
        kw = calib if profile == "int8" else {}
        for mode, buckets in (("bucketed", EVAL_BUCKETS), ("exact", None)):
            t0 = time.perf_counter()
            d = DetectorPredictor(cfg, det_state, threshold=det.threshold,
                                  buckets=buckets, profile=profile, **kw)
            n = DenoiserPredictor(cfg, den_state, buckets=buckets,
                                  profile=profile, **kw)
            run_detect(d, wavs[:2], frames[:2])  # warm-up
            run_denoise(n, wavs[:2], bits[:2])
            reset_launches()
            dets, d_s = timed(lambda: run_detect(d, wavs, frames))
            dens, n_s = timed(lambda: run_denoise(n, wavs, bits))
            results[(profile, mode)] = (dets, dens)
            fill = ("" if buckets is None else
                    f"; fill: detect {bucket_fill(d, wavs, frames)}, "
                    f"denoise {bucket_fill(n, wavs)}")
            log(f"eval throughput {profile} {mode}: detect "
                f"{audio_s / d_s:.1f} audio-s/s ({d_s:.2f} s), denoise "
                f"{audio_s / n_s:.1f} audio-s/s ({n_s:.2f} s){fill} "
                f"{card_note()}")
            if profile == "int8":
                check_int8_eval_launches(mode)
                if mode == "bucketed":
                    int8_launches = dict(LAUNCHES)
                t_int8 += time.perf_counter() - t0
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
    t0 = time.perf_counter()
    check_int8_eval(results, cfg, det_state, den_state, det.threshold,
                    wavs, frames, bits, calib)
    t_int8 += time.perf_counter() - t0
    log(f"eval int8 part: {t_int8:.1f} s")

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
    launches.update({k: int8_launches[k] for k in INT8_EVAL_KERNELS})
    return launches


def check_int8_eval_launches(mode: str) -> None:
    """The int8 chain's launches since the last reset: the bucketed mode
    through K6's and K7's valid_t cases; neither mode through the
    mma.sync gather of K7 (every full-width block has a tile plan, rows
    of any width in segments)."""
    log(f"eval int8 {mode} launches: {dict(LAUNCHES)}; by entry point: "
        f"{dict(ENTRY_LAUNCHES)}")
    if mode == "bucketed":
        missing = [k for k in INT8_EVAL_KERNELS if LAUNCHES[k] == 0]
        if missing:
            raise RuntimeError(f"eval int8 chain never launched: {missing}")
    if ENTRY_LAUNCHES["sos_int8_conv_inpaint"]:
        raise RuntimeError(f"eval int8 {mode}: K7 fell back to the mma.sync "
                           f"gather {ENTRY_LAUNCHES['sos_int8_conv_inpaint']}"
                           " times")
    if ENTRY_LAUNCHES["sos_int8_inpaint_halo"] == 0:
        raise RuntimeError(f"eval int8 {mode}: K7's tile never launched")


def resize_ties(valid_t: int, frames: int):
    """Frames where the exact mode's resize index, floor(j * (T /
    frames)) in float64, and the bucketed mode's, floor(j * T / frames)
    in integers (both `sos_tpu`'s), part. At such a tie the two modes
    read adjacent STFT frames, and their int8 confidences differ by up to
    8e-5 with no fault (PERF.md §6, PR 10)."""
    fixed = nearest_index_tensor(valid_t, frames, torch.device("cpu"))
    dyn = torch.clamp(torch.arange(frames) * valid_t // frames, 0,
                      valid_t - 1)
    return (fixed != dyn).nonzero().reshape(-1).tolist()


def check_int8_eval(results, cfg, det_state, den_state, threshold, wavs,
                    frames, bits, calib) -> None:
    """int8 bucketed against int8 exact on the card (sos_tpu's bounds:
    confidences 2e-5, waveforms 3e-5, bits equal), and the card against
    the CPU, bucketed, on the 2.0 s utterance and the shortest one over
    2.1 s (1e-3, bits equal where the CPU's confidence is 1e-4 clear of
    the threshold, as for f32)."""
    from sos_tpu_torch.infer import DenoiserPredictor, DetectorPredictor

    (b_det, b_den), (e_det, e_den) = (results[("int8", "bucketed")],
                                      results[("int8", "exact")])
    near = lambda conf, m: np.abs(conf - threshold) <= m  # noqa: E731
    diffs = [np.abs(b[1] - e[1]) for b, e in zip(b_det, e_det)]
    worst = int(np.argmax([d.max() for d in diffs]))
    conf_diff = float(diffs[worst].max())
    bits_ok = all(np.array_equal(b[0][~near(e[1], 1e-4)],
                                 e[0][~near(e[1], 1e-4)])
                  for b, e in zip(b_det, e_det))
    wav_diff = max(float(np.abs(b - e).max()) for b, e in zip(b_den, e_den))
    valid_t = 1 + len(wavs[worst]) // cfg.stft.hop_length
    log(f"eval int8 bucketed vs exact on the card: confidences max |diff| "
        f"{conf_diff:.3e} (tolerance 2e-5; utterance {worst}, frame "
        f"{int(np.argmax(diffs[worst]))}, resize ties "
        f"{resize_ties(valid_t, frames[worst])}), waveforms max |diff| "
        f"{wav_diff:.3e} (tolerance 3e-5), bits equal off the threshold "
        f"{bits_ok}")
    if not (conf_diff <= 2e-5 and wav_diff <= 3e-5 and bits_ok):
        raise RuntimeError("eval int8: bucketed and exact disagree on the "
                           "card")
    long_i = min((i for i, w in enumerate(wavs) if len(w) > 2.1 * SR),
                 key=lambda i: len(wavs[i]))
    picks = [0, long_i]
    d_cpu = DetectorPredictor(cfg, det_state, threshold=threshold,
                              buckets=EVAL_BUCKETS, profile="int8",
                              device="cpu", **calib)
    n_cpu = DenoiserPredictor(cfg, den_state, buckets=EVAL_BUCKETS,
                              profile="int8", device="cpu", **calib)
    t0 = time.perf_counter()
    c_det = run_detect(d_cpu, [wavs[i] for i in picks],
                       [frames[i] for i in picks], batched=False)
    c_den = run_denoise(n_cpu, [wavs[i] for i in picks],
                        [bits[i] for i in picks], batched=False)
    for j, i in enumerate(picks):
        secs = len(wavs[i]) / SR
        cd = float(np.abs(c_det[j][1] - b_det[i][1]).max())
        off = ~near(c_det[j][1], 1e-4)
        equal = bool(np.array_equal(c_det[j][0][off], b_det[i][0][off]))
        wd = float(np.abs(c_den[j] - b_den[i]).max())
        finite = bool(np.isfinite(b_den[i]).all())
        log(f"eval int8 card vs cpu, {secs:.2f} s utterance: confidences max "
            f"|diff| {cd:.3e}, waveform finite {finite} max |diff| {wd:.3e} "
            f"(tolerance 1e-3), bits equal off the threshold {equal} "
            f"({int(off.sum())}/{len(off)} frames 1e-4 clear of it)")
        if not (cd <= 1e-3 and wd <= 1e-3 and equal and finite):
            raise RuntimeError(f"eval int8: card disagrees with the CPU at "
                               f"{secs:.2f} s")
    log(f"eval int8 CPU references: {time.perf_counter() - t0:.1f} s")


# -- training: train steps, timed training, fit() through the CLI ------------

# the kernels each stage's train step launches: K1 (the denoiser's four
# STFTs in one launch), K2's complement (the clean signal), K2 (the
# denoiser's gated mixture), K4's training instance and K4b
TRAIN_KERNELS = {
    "detector": ("stft", "mask_gate_complement", "bilstm_train",
                 "bilstm_bwd"),
    "denoiser": ("stft", "mask_gate", "mask_gate_complement", "bilstm_train",
                 "bilstm_bwd"),
}
TRAIN_BATCH = {"detector": 15, "denoiser": 40}  # TrainConfig, m2 common.py:52


def lstm_route(names, cfg: ExperimentConfig, stage: str):
    """The launch counters `names` as the stage's BiLSTM counts them: K4's
    and K4b's with "_wide" after them where its hidden size takes the
    wide route."""
    hidden = (cfg.detector if stage == "detector" else cfg.denoiser).lstm_hidden
    wide = isinstance(recurrence_plan(1, hidden), WidePlan)
    return tuple(f"{n}_wide" if wide and n.startswith("bilstm") else n
                 for n in names)
TRAIN_TIMED_STEPS = 5
# median step ms of each timed training: (stage, dtype, remat, batch) -> ms
STEP_MS = {}
# device-time categories of one train step, matched in this order
TRAIN_CATEGORIES = (
    ("K4b bilstm backward", ("bilstm_bwd_kernel",)),
    ("K4 bilstm training forward", ("bilstm_train_kernel",)),
    ("K1 stft", ("stft_analysis_pfa",)),
    ("K2 mask_gate (both instances)", ("mask_gate_kernel",)),
    ("optimizer (Adam, foreach)", ("multi_tensor_apply",)),
    # the FFT algorithm of a convolution, forward or backward: transforms,
    # complex GEMMs, the pointwise product
    ("cuDNN FFT convolutions", ("cf32", "fft", "pointwise_mult_and_sum")),
    ("cuDNN layout conversions (NCHW <-> NHWC)",
     ("nchwToNhwc", "nhwcToNchw")),
    ("cuDNN conv backward (data and weight gradients)",
     ("dgrad", "wgrad", "bprop", "backward_data", "backward_filter",
      "convolve_common_engine_float_NHWC")),
    ("cuDNN conv forward", ("conv", "cudnn", "fprop", "winograd", "implicit",
                            "Nchw", "nchw", "Nhwc", "nhwc")),
    ("reductions (BN statistics and their gradients, losses, finiteness)",
     ("reduce_kernel",)),
    ("elementwise (BN, activations, cRM, copies)",
     ("elementwise_kernel", "copy_kernel", "CatArrayBatchedCopy")),
    ("matmuls (LSTM projections and dW_hh, heads)",
     ("gemm", "Gemm", "cutlass", "cublas")),
)


def train_batch(n: int, gen: torch.Generator):
    """A seeded synthetic batch as the batchers give it (numpy): clean
    clips, noise crops, SNRs over the config's range, and bits with a
    silent run in every clip."""
    bits = (torch.rand(n, 60, generator=gen) < 0.5).float()
    bits[:, :5] = 0.0
    return {"clean": make_clips(n, gen).numpy(),
            "noise": (torch.randn(n, CLIP, generator=gen) * 0.1).numpy(),
            "snr": np.asarray([(-5.0, 0.0, 5.0, 10.0)[i % 4]
                               for i in range(n)], np.float32),
            "bits": bits.numpy()}


def fresh_state_dicts(cfg):
    """Fresh seeded weights of both stages, as the train CLIs start."""
    return {"detector": train_loop.fresh_state_dict(
                SilenceDetector(cfg.detector), SEED),
            "denoiser": train_loop.fresh_state_dict(
                JointDenoiser(cfg.denoiser), SEED)}


def _init(stage, cfg, device, state_dict):
    init = (train_loop.init_detector_state if stage == "detector"
            else train_loop.init_denoiser_state)
    return init(cfg, device=device, state_dict=state_dict)[1]


def _head_modules(stage, model):
    """The stage's BiLSTM and the linear layers after it (the last
    returns the head's logits)."""
    m = model if stage == "detector" else model.context
    fcs = ("fc1", "fc2") if stage == "detector" else ("fc0", "fc1", "fc2")
    return m.lstm, [getattr(m, n) for n in fcs]


def head_forward(stage, model, x, masks=None, pre=None):
    """The BiLSTM and heads from their input features to the logits.
    `masks`: a mask for each ReLU, taken in place of its own sign test
    (z * mask, whose gradient is the incoming one times the mask);
    `pre`: a list that receives each ReLU's pre-activations z."""
    lstm, fcs = _head_modules(stage, model)
    h = lstm(x)
    for i, fc in enumerate(fcs[:-1]):
        z = fc(h)
        if pre is not None:
            pre.append(z.detach())
        h = torch.relu(z) if masks is None else z * masks[i].to(z)
    return fcs[-1](h)


def step_with_gradients(stage, cfg, state, batch, inputs):
    """One train step (the body of `make_*_train_step`) on the stage's
    device-stage `inputs` that keeps the gradients: (loss, gradients on
    the CPU, applied, the head's input features and the loss's gradient
    at its logits)."""
    loss_fn = (train_loop.detector_loss if stage == "detector"
               else train_loop.denoiser_loss)
    head = {}

    def keep_features(_, args):
        head["x"] = args[0].detach().clone()

    def keep_gradient(_, __, logits):
        logits.register_hook(lambda g: head.update(g=g.detach().clone()))

    lstm, fcs = _head_modules(stage, state.model)
    hooks = [lstm.register_forward_pre_hook(keep_features),
             fcs[-1].register_forward_hook(keep_gradient)]
    state.model.train()
    try:
        with exact_fp32():
            loss = loss_fn(cfg, state.model, inputs)[0]
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            grads = {n: p.grad.detach().cpu().clone()
                     for n, p in state.model.named_parameters()}
            applied = train_loop.guarded_update(state, cfg.train.lr, True)
    finally:
        for h in hooks:
            h.remove()
    return float(loss.detach()), grads, applied, head


def head_gradients(stage, cfg, state_dict, dev, x, g, masks=None):
    """The BiLSTM's and heads' gradients (and the features') on `dev`
    from the given features `x` and logits' gradient `g`, and the ReLUs'
    pre-activations on the CPU. `masks`: as `head_forward`'s."""
    model = _init(stage, cfg, dev, state_dict).model.train()
    x = x.detach().to(dev).requires_grad_(True)
    pre = []
    with exact_fp32():
        head_forward(stage, model, x, masks, pre).backward(g.to(dev))
    lstm, fcs = _head_modules(stage, model)
    grads = {f"{pre}{n}": p.grad.detach().cpu() for pre, mod in
             (("lstm.", lstm), ("fc.", torch.nn.ModuleList(fcs)))
             for n, p in mod.named_parameters()}
    grads["features"] = x.grad.detach().cpu()
    return grads, [z.cpu() for z in pre]


# How close to 0 (of the layer's max |z|) a ReLU's pre-activation may lie
# where the card's and the CPU's signs differ: a few times the rounding
# of a 400- or 600-term fp32 dot product, far below any real fault.
KINK_BAND = 1e-5


def head_agreement(stage, cfg, state_dict, x, g):
    """The BiLSTM's and heads' gradients (and the features'), card
    against CPU, from the same features `x` and logits' gradient `g`.

    ReLU has no derivative at 0. Where a pre-activation lies within the
    two devices' rounding of 0, either side may take either branch, and
    that unit's whole gradient then differs: one such unit of the
    denoiser's 427,200 moves the features' gradient by 1e-3 of its max
    or more, with no fault on either side. So the CPU takes the card's ReLU masks, and the units
    whose own signs differ are counted and must lie within KINK_BAND of
    0. Returns a dict: `errs` (per tensor, of its max |g|), `l2`
    (relative, all tensors), `launches` (the card's BiLSTM kernels),
    `worst` (the tensor of the largest error), and of the ReLUs'
    pre-activations, each of its layer's max |z|: `gap` (the largest
    |z_card - z_cpu|), `kinks` (units whose signs differ), `widest` (the
    largest |z| of those) and `nearest` (the smallest |z| of all)."""
    reset_launches()
    card, z_card = head_gradients(stage, cfg, state_dict, "cuda", x, g)
    launches = {k: LAUNCHES[k] for k in lstm_route(
        ("bilstm_train", "bilstm_bwd"), cfg, stage)}
    cpu, z_cpu = head_gradients(stage, cfg, state_dict, "cpu", x, g,
                                masks=[z > 0 for z in z_card])
    errs, l2 = _gradient_spread(card, cpu)
    out = {"errs": errs, "l2": l2, "launches": launches,
           "worst": max(errs, key=errs.get), "gap": 0.0, "kinks": 0,
           "widest": 0.0, "nearest": 1.0}
    for zc, zp in zip(z_card, z_cpu):
        scale = float(zp.abs().max())
        differ = (zc > 0) != (zp > 0)
        out["gap"] = max(out["gap"], float((zc - zp).abs().max()) / scale)
        out["kinks"] += int(differ.sum())
        out["nearest"] = min(out["nearest"], float(zp.abs().min()) / scale)
        if differ.any():
            out["widest"] = max(out["widest"], float(torch.maximum(
                zc[differ].abs(), zp[differ].abs()).max()) / scale)
    return out


def kink_note(head) -> str:
    """`head_agreement`'s ReLU figures for a log line."""
    return (f"ReLU pre-activations card against CPU {head['gap']:.2e} of "
            f"their max, nearest to 0 {head['nearest']:.2e}, "
            f"{head['kinks']} of differing sign (the CPU takes the "
            f"card's) within {head['widest']:.2e} of 0 (band "
            f"{KINK_BAND:g})")


# the parameters past the conv trunks: the BiLSTM (whose gradients K4's
# training instance and K4b give) and the heads
HEAD_PARAMS = ("lstm.", "fc", "context.lstm.", "context.fc")


def _relative_l2(got, ref) -> float:
    return (sum(float(((got[n] - g) ** 2).sum()) for n, g in ref.items())
            / sum(float((g ** 2).sum()) for g in ref.values())) ** 0.5


def _gradient_spread(got, ref):
    """Per tensor |got - ref| max over ref's max |g| -> (errors, relative
    L2 over all tensors)."""
    errs = {n: float((got[n] - g).abs().max()) / max(float(g.abs().max()),
                                                      1e-30)
            for n, g in ref.items()}
    return errs, _relative_l2(got, ref)


def _worst(errs, head: bool) -> str:
    part = {n: e for n, e in errs.items() if n.startswith(HEAD_PARAMS) == head}
    n = max(part, key=part.get)
    return f"{n} {part[n]:.2e}"


STAGE_INPUTS = {"detector": train_loop.detector_inputs,
                "denoiser": train_loop.denoiser_inputs}
AGREEMENT_RUNS = ("card", "card deterministic", "cpu", "cpu own input")


def train_agreement(stage, cfg, state_dict, gen, make_inputs=None,
                    runs=AGREEMENT_RUNS, label="", batch=None):
    """One train step at batch 2 from the same weights and batch on the
    card and on the CPU. The card makes the step's inputs (`make_inputs`,
    the stage's own device stage by default: mix, STFTs) and steps on
    them; the CPU steps on a copy of them (one fixed input) and, apart,
    on the inputs it makes itself. Held: the loss within 1e-4 relative
    and the new BatchNorm statistics within 1e-5, for both CPU steps; all
    gradients within 5e-2 relative L2 on the fixed input; and the
    BiLSTM's and heads' gradients (and the features') within 1e-3 of
    each tensor's max |g|, card against CPU, from the card step's own
    head features and logits' gradient. Logged beside them, as witnesses
    of what moves the rest: how far the head features of the card and
    the CPU drift apart on the fixed input, the CPU's own-input step
    against its fixed-input step (the device stages' rounding alone),
    and the card against itself with cuDNN's deterministic algorithms
    (`runs` may leave those two out). The training path's launch
    counters must rise on the card. `batch`: a new seeded one of 2 clips
    unless given. Returns the card step's loss, the CPU's fixed-input
    step's seconds and the card step's launch counts."""
    batch = train_batch(2, gen) if batch is None else batch
    make_inputs = make_inputs or STAGE_INPUTS[stage]
    name = f"{stage}{label}"
    if "cpu own input" in runs:
        with exact_fp32():
            own_in = make_inputs(cfg, batch, "cpu")
    out = {}
    for run in runs:
        dev = "cuda" if run.startswith("card") else "cpu"
        state = _init(stage, cfg, dev, state_dict)
        reset_launches()
        t0 = time.perf_counter()
        if run == "card":
            with exact_fp32():
                card_in = make_inputs(cfg, batch, dev)
            fixed = {k: v.cpu() for k, v in card_in.items()}
        inputs = own_in if run == "cpu own input" else {
            "card": card_in, "card deterministic": card_in,
            "cpu": fixed}[run]
        torch.backends.cudnn.deterministic = run == "card deterministic"
        try:
            loss, grads, applied, head = step_with_gradients(
                stage, cfg, state, batch, inputs)
        finally:
            torch.backends.cudnn.deterministic = False
        if dev == "cuda":
            torch.cuda.synchronize()
        stats = {n: b.detach().cpu() for n, b in state.model.named_buffers()}
        out[run] = (loss, grads, stats, applied, time.perf_counter() - t0,
                    dict(LAUNCHES), head)
    l_gpu, g_gpu, s_gpu, a_gpu, t_gpu, launches, h_gpu = out["card"]
    l_cpu, g_cpu, s_cpu, a_cpu, t_cpu, _, h_cpu = out["cpu"]
    cpu_runs = [out[r] for r in ("cpu", "cpu own input") if r in out]
    rel = max(abs(l_gpu - o[0]) / abs(o[0]) for o in cpu_runs)
    s_err = max(float((s_gpu[n] - v).abs().max()) for o in cpu_runs
                for n, v in o[2].items())
    errs, l2 = _gradient_spread(g_gpu, g_cpu)
    feat = float((h_gpu["x"].cpu() - h_cpu["x"]).abs().max()
                 / h_cpu["x"].abs().max())
    heads = head_agreement(stage, cfg, state_dict, h_gpu["x"], h_gpu["g"])
    head_errs, head_worst = heads["errs"], heads["worst"]
    kernels = lstm_route(TRAIN_KERNELS[stage], cfg, stage)
    missing = [k for k in kernels if launches[k] == 0]
    missing += [k for k, v in heads["launches"].items() if v == 0]
    log(f"train agreement {name} (batch 2, full width): loss card "
        f"{l_gpu:.6f} " + " ".join(f"{r} {out[r][0]:.6f}" for r in runs
                                   if r.startswith("cpu"))
        + f" (worst rel {rel:.2e}, tolerance 1e-4); BN statistics "
        f"{s_err:.2e} (tolerance 1e-5); applied "
        f"{[out[r][3] for r in runs]}; CPU steps "
        f"{' + '.join(f'{o[4]:.1f}' for o in cpu_runs)} s, card step "
        f"{t_gpu:.2f} s; launches "
        f"{ {k: launches[k] for k in kernels} }")
    if "cpu own input" in out:
        in_diff = max(float((own_in[k] - v).abs().max())
                      for k, v in fixed.items())
        log(f"  the device stages' outputs {name}, card against CPU: "
            f"{in_diff:.2e}")
    log(f"  BiLSTM and heads {name} from the card step's features and "
        f"logits' gradient, card against CPU: worst {head_worst} "
        f"{head_errs[head_worst]:.2e} of its max |g| (tolerance 1e-3), "
        f"relative L2 {heads['l2']:.2e}; launches {heads['launches']}; "
        + kink_note(heads))
    log(f"  the head's features {name}, card against CPU on the fixed "
        f"input: {feat:.2e} of their max |x|")
    witnesses = [("card against CPU, fixed input", (errs, l2))]
    if "cpu own input" in out:
        witnesses += [("CPU own input against CPU fixed input",
                       _gradient_spread(out["cpu own input"][1], g_cpu)),
                      ("card against CPU own input",
                       _gradient_spread(g_gpu, out["cpu own input"][1]))]
    if "card deterministic" in out:
        witnesses.append(("card deterministic cuDNN against card",
                          _gradient_spread(out["card deterministic"][1],
                                           g_gpu)))
    for what, (e, l2_) in witnesses:
        log(f"  gradients {name}, {what}: relative L2 {l2_:.2e}; worst of "
            f"its max |g|: BiLSTM and heads {_worst(e, True)}, trunks "
            f"{_worst(e, False)}; tensors over 1e-3 "
            f"{sum(v > 1e-3 for v in e.values())}/{len(e)}")
    if missing:
        raise RuntimeError(f"train step {name} never launched {missing}")
    failed = [what for what, ok in (
        (f"applied {[out[r][3] for r in runs]}",
         all(out[r][3] for r in runs)),
        (f"loss {rel:.3e} relative (tolerance 1e-4)", rel <= 1e-4),
        (f"BN statistics {s_err:.3e} (tolerance 1e-5)", s_err <= 1e-5),
        (f"BiLSTM and heads {head_worst} {head_errs[head_worst]:.3e} of its "
         f"max |g| (tolerance 1e-3)", head_errs[head_worst] <= 1e-3),
        (f"{heads['kinks']} ReLU units of differing sign, within "
         f"{heads['widest']:.3e} of 0 (band {KINK_BAND:g})",
         heads["widest"] <= KINK_BAND),
        (f"gradients {l2:.3e} relative L2 (tolerance 5e-2); worst tensors "
         f"{_worst(errs, True)}, {_worst(errs, False)}", l2 <= 5e-2))
        if not ok]
    if failed:
        raise RuntimeError(f"train step {name}: card disagrees with the CPU: "
                           + "; ".join(failed))
    return l_gpu, t_cpu, launches


def stage_step(stage, cfg, state_dicts, n, gen):
    """A closure running the real train step of `stage` ("detector",
    "denoiser" or "joint") on the card at batch `n`, from the given
    weights, on one seeded batch; it returns the step's metrics."""
    batch = train_batch(n, gen)
    if stage == "joint":
        det = _init("detector", cfg, "cuda", state_dicts["detector"])
        den = _init("denoiser", cfg, "cuda", state_dicts["denoiser"])
        step = joint.make_joint_train_step(cfg, 100)
        return lambda: step(det, den, batch)[2]
    make = (train_loop.make_detector_train_step if stage == "detector"
            else train_loop.make_denoiser_train_step)
    state = _init(stage, cfg, "cuda", state_dicts[stage])
    step = make(cfg, 100)
    return lambda: step(state, batch)[1]


# the losses each stage's step reports
STEP_LOSSES = {"detector": ("loss",), "denoiser": ("loss",),
               "joint": ("detector_loss", "denoiser_loss")}


def timed_training(stage, cfg, state_dicts, gen, batches=None):
    """The real train step of `stage` on the card: median step ms of
    TRAIN_TIMED_STEPS after 2 warm-up steps, clips/s, audio-s/s trained,
    peak memory, a profiler breakdown of one step. `batches`: the
    batches to try in turn (default the stage's TRAIN_BATCH); one that
    does not fit the card's memory is logged as such and the next is
    tried. Returns the launches of the timed steps."""
    dtype = (f"{cfg.train.compute_dtype}, remat {cfg.train.remat}")
    for n in batches or (TRAIN_BATCH["detector" if stage == "joint"
                                     else stage],):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            step = stage_step(stage, cfg, state_dicts, n, gen)
            for _ in range(2):
                step()
            torch.cuda.synchronize()
            break
        except torch.cuda.OutOfMemoryError:
            step = None
            log(f"training {stage} ({dtype}) {card_note()}: batch {n} does "
                f"not fit the card (peak "
                f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
                f"before the failed allocation)")
    if step is None:
        raise RuntimeError(f"timed training {stage}: no batch fits")
    reset_launches()
    times, losses = [], []
    for _ in range(TRAIN_TIMED_STEPS):
        t0 = time.perf_counter()
        metrics = step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append([metrics[k] for k in STEP_LOSSES[stage]])
        if metrics["finite"] != 1.0 or not np.isfinite(losses[-1]).all():
            raise RuntimeError(f"timed training {stage}: non-finite step")
    launches = dict(LAUNCHES)
    med = statistics.median(times)
    STEP_MS[(stage, cfg.train.compute_dtype, cfg.train.remat, n)] = med * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    kernels = TRAIN_KERNELS["denoiser" if stage == "joint" else stage]
    log(f"training {stage} ({dtype}) {card_note()}: batch {n}, median "
        f"step {med * 1e3:.1f} ms (min {min(times) * 1e3:.1f}, max "
        f"{max(times) * 1e3:.1f}) -> {n / med:.1f} clips/s, "
        f"{n * CLIP / 14000.0 / med:.1f} audio-s/s trained"
        + (" for each stage" if stage == "joint" else "")
        + f"; peak memory {peak:.2f} GiB; losses "
        f"{[[round(x, 5) for x in ls] for ls in losses]}; launches per step "
        f"{ {k: launches[k] / TRAIN_TIMED_STEPS for k in kernels} }")
    prof = profile_call(step, TRAIN_CATEGORIES)
    if prof is not None:
        log(f"profile training {stage} ({dtype}): wall "
            f"{prof['wall_ms']:.1f} ms, device {prof['device_ms']:.1f} ms, "
            f"idle share {prof['idle_share']:.3f}; " + ", ".join(
                f"{k} {v:.2f} ms" for k, v in prof["categories_ms"].items()))
        for name, ms in prof["top_kernels_ms"]:
            log(f"    {ms:9.2f} ms  {name}")
    del step
    torch.cuda.empty_cache()
    return launches


def train_corpus(root: str, gen: torch.Generator, seconds: int = 6) -> str:
    """Four seeded utterances of `seconds` (6 s: 20 detector windows)
    with bitstreams and two 8 s noise WAVs (`root/noise`). Returns the
    dataset JSON."""
    os.makedirs(os.path.join(root, "clips"))
    os.makedirs(os.path.join(root, "noise"))
    files = []
    for i in range(4):
        n = seconds * SR
        path = os.path.join(root, "clips", f"t{i}.wav")
        audio_io.write_wav(path, utterance(n, gen), SR)
        centres = (np.arange(30 * seconds) + 0.5) / 30.0
        files.append({"path": path, "audio_path": path, "framerate": 30,
                      "audio_sample_rate": SR, "audio_samples": n,
                      "duration": float(seconds), "num_frames": 30 * seconds,
                      "bit_stream": "".join(
                          "1" if np.sin(2 * np.pi * 1.5 * c) > 0 else "0"
                          for c in centres)})
    for i in range(2):
        audio_io.write_wav(os.path.join(root, "noise", f"n{i}.wav"),
                           (torch.randn(8 * SR, generator=gen) * 0.1).numpy(),
                           SR)
    ds_json = os.path.join(root, "ds.json")
    with open(ds_json, "w") as fp:
        json.dump({"dataset_path": os.path.join(root, "clips"),
                   "num_videos": len(files), "files": files}, fp)
    return ds_json


def _strict_json(path: str):
    def refuse(token):
        raise ValueError(f"{path}: non-standard JSON token {token}")
    with open(path) as fp:
        return json.loads(fp.read(), parse_constant=refuse)


def cli_fit(workdir: str, gen: torch.Generator) -> None:
    """`python -m sos_tpu_torch.cli.train_detector` at full width on the
    card: 1 epoch with a `latest` every step, then `--continue --ckpt
    latest` to epoch 2; `latest.clock.json` must advance and stay strict
    JSON."""
    root = os.path.join(workdir, "train_cli")
    ds_json = train_corpus(root, gen)
    base = [sys.executable, "-m", "sos_tpu_torch.cli.train_detector",
            "--dataset_json", ds_json, "--noise_root",
            os.path.join(root, "noise"), "--output_root",
            os.path.join(root, "out"), "--name", "smoke", "--batch_size", "4",
            "--save_step_frequency", "1"]
    clock_path = os.path.join(root, "out", "smoke_detector", "model",
                              "latest.clock.json")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    clocks = []
    for extra in (["--epochs", "1"],
                  ["--epochs", "2", "--continue", "--ckpt", "latest"]):
        t0 = time.perf_counter()
        run = subprocess.run(base + extra, cwd=here, env=env, timeout=300,
                             capture_output=True, text=True)
        if run.returncode != 0:
            raise RuntimeError(f"train_detector {' '.join(extra)} failed:\n"
                               + run.stderr[-3000:])
        clocks.append(_strict_json(clock_path))
        log(f"train_detector CLI {' '.join(extra)}: "
            f"{time.perf_counter() - t0:.1f} s, latest.clock.json "
            f"{clocks[-1]}" + (f"; {run.stdout.strip()}" if run.stdout
                               else ""))
    if not (clocks[0]["epoch"] == 1 and clocks[0]["step"] > 0
            and clocks[1]["epoch"] == 2
            and clocks[1]["step"] == 2 * clocks[0]["step"]):
        raise RuntimeError(f"train_detector --continue did not advance "
                           f"latest.clock.json: {clocks}")


def phase_training(cfg: ExperimentConfig, gen: torch.Generator,
                   workdir: str):
    """Phase 8 (see the module docstring). Returns the launches of the
    timed train steps of both stages."""
    t_phase = time.perf_counter()
    launches = {k: 0 for k in LAUNCHES}
    state_dicts = fresh_state_dicts(cfg)
    for stage in ("detector", "denoiser"):
        train_agreement(stage, cfg, state_dicts[stage], gen)
        for k, v in timed_training(stage, cfg, state_dicts, gen).items():
            launches[k] += v
    cli_fit(workdir, gen)
    log(f"training phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


# -- joint and bf16 training, checkpoints end to end -------------------------

# launches of one joint step: K1 (the four stacked STFTs), K2, K2's
# complement, and K4's training instance and K4b once a stage
JOINT_LAUNCHES = {"stft": 1, "mask_gate": 1, "mask_gate_complement": 1,
                  "bilstm_train": 2, "bilstm_bwd": 2}
# bf16 step against f32 step from the same weights and inputs, (relative
# loss gap, relative L2 of all gradients): the farthest bf16 moves
# sos_tpu's own train step from its f32 step at the reference depth, over
# 16 weight and batch draws, rounded up (tests/test_torch_bf16_bounds.py)
BF16_BOUNDS = {"detector": (1.3e-3, 0.55), "denoiser": (6.6e-3, 1.14)}
# the CPU's bf16 step is held beside the card's when it should take less
CPU_BF16_LIMIT_S = 60.0


def bf16_config(cfg: ExperimentConfig) -> ExperimentConfig:
    """`--compute_dtype bfloat16 --no_remat`."""
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, compute_dtype="bfloat16", remat=False))


def joint_stage_inputs(stage):
    """The joint step's inputs of one stage (`joint.joint_inputs`)."""
    def make(cfg, batch, device):
        d, det_in = joint.joint_inputs(cfg, batch, device)
        return det_in if stage == "detector" else d
    return make


def joint_agreement(cfg, state_dicts, gen):
    """Phase 9.1: the real joint step at batch 2 on the card (its
    launches exactly JOINT_LAUNCHES, finite), then each stage's part of
    it on the same batch, card against CPU on the card's device-stage
    outputs (`train_agreement`'s bounds), the card's losses within 1e-4
    of the joint step's. Returns each stage's CPU step seconds."""
    batch = train_batch(2, gen)
    det = _init("detector", cfg, "cuda", state_dicts["detector"])
    den = _init("denoiser", cfg, "cuda", state_dicts["denoiser"])
    reset_launches()
    _, _, metrics = joint.make_joint_train_step(cfg, 100)(det, den, batch)
    torch.cuda.synchronize()
    launches = {k: LAUNCHES[k] for k in JOINT_LAUNCHES}
    log(f"joint step (batch 2, full width) on the card: {metrics}; "
        f"launches {launches}")
    del det, den
    if launches != JOINT_LAUNCHES or metrics["finite"] != 1.0:
        raise RuntimeError(f"joint step: launches {launches} (expected "
                           f"{JOINT_LAUNCHES}), finite {metrics['finite']}")
    cpu_s = {}
    for stage in ("detector", "denoiser"):
        loss, cpu_s[stage], _ = train_agreement(
            stage, cfg, state_dicts[stage], gen, joint_stage_inputs(stage),
            runs=("card", "cpu"), label=" (joint step)", batch=batch)
        ref = metrics[f"{stage}_loss"]
        if abs(loss - ref) > 1e-4 * abs(ref):
            raise RuntimeError(f"joint step {stage}: loss {ref} against "
                               f"its part's {loss}")
    return cpu_s


def bf16_agreement(stage, cfg, state_dict, gen, cpu_estimate_s):
    """Phase 9.2: one bf16 --no_remat step of `stage` at batch 2 on the
    card against the card's f32 step from the same weights and inputs:
    the relative loss gap and the relative L2 of all gradients within
    BF16_BOUNDS; the BiLSTM's and heads' gradients from the bf16 step's
    own features within 1e-3 of max |g|, card against CPU; the training
    kernels launched. The CPU's bf16 step on the same inputs is held to
    BF16_BOUNDS too when it should take under CPU_BF16_LIMIT_S
    (`cpu_estimate_s`), else skipped with the reason logged. Returns the
    CPU bf16 step's seconds (None when skipped)."""
    cfg16 = bf16_config(cfg)
    batch = train_batch(2, gen)
    reset_launches()
    with exact_fp32():
        card_in = STAGE_INPUTS[stage](cfg, batch, "cuda")
    # the device stage's kernels, then the bf16 step's own
    launches = {k: LAUNCHES[k] for k in TRAIN_KERNELS[stage]
                if not k.startswith("bilstm")}
    l32, g32, _, _ = step_with_gradients(
        stage, cfg, _init(stage, cfg, "cuda", state_dict), batch, card_in)
    reset_launches()
    l16, g16, applied, head = step_with_gradients(
        stage, cfg16, _init(stage, cfg16, "cuda", state_dict), batch,
        card_in)
    torch.cuda.synchronize()
    launches.update({k: LAUNCHES[k] for k in ("bilstm_train", "bilstm_bwd")})
    gap = (abs(l16 - l32) / abs(l32), _relative_l2(g16, g32))
    heads = head_agreement(stage, cfg16, state_dict, head["x"], head["g"])
    head_errs, head_worst = heads["errs"], heads["worst"]
    bounds = BF16_BOUNDS[stage]
    log(f"bf16 step {stage} (batch 2, full width, no remat) against the "
        f"f32 step, card: loss {l16:.6f} / {l32:.6f}, gap {gap[0]:.3e} "
        f"(bound {bounds[0]:.1e}), gradients relative L2 {gap[1]:.3e} "
        f"(bound {bounds[1]}); BiLSTM and heads from its features, card "
        f"against CPU: worst {head_worst} {head_errs[head_worst]:.2e} "
        f"(tolerance 1e-3), {kink_note(heads)}; launches {launches}")
    ok = (applied and gap[0] <= bounds[0] and gap[1] <= bounds[1]
          and head_errs[head_worst] <= 1e-3
          and heads["widest"] <= KINK_BAND
          and all(launches.values()))
    cpu_s = None
    if cpu_estimate_s < CPU_BF16_LIMIT_S:
        t0 = time.perf_counter()
        lc, gc, ac, _ = step_with_gradients(
            stage, cfg16, _init(stage, cfg16, "cpu", state_dict), batch,
            {k: v.cpu() for k, v in card_in.items()})
        cpu_s = time.perf_counter() - t0
        cpu_gap = (abs(l16 - lc) / abs(lc), _relative_l2(g16, gc))
        log(f"  bf16 step {stage}, card against CPU ({cpu_s:.1f} s): loss "
            f"gap {cpu_gap[0]:.3e}, gradients relative L2 "
            f"{cpu_gap[1]:.3e} (bounds {bounds})")
        ok = ok and ac and cpu_gap[0] <= bounds[0] and cpu_gap[1] <= bounds[1]
    else:
        log(f"  bf16 step {stage}, card against CPU: skipped, the CPU's "
            f"bf16 step would take about {cpu_estimate_s:.0f} s (limit "
            f"{CPU_BF16_LIMIT_S:.0f} s)")
    if not ok:
        raise RuntimeError(f"bf16 step {stage}: outside its bounds")
    return cpu_s


def run_cli(module, argv) -> None:
    """`python -m <module> <argv>` in this process, so that the kernels
    it launches count here."""
    saved = sys.argv
    sys.argv = [module.__name__] + list(argv)
    try:
        module.main()
    finally:
        sys.argv = saved


def reference_detector_state(state_dict):
    """The port's detector weights in the reference's `.pth` layout
    (`AudioVisualNet`, m1 networks.py; what `models/torch_import.py`
    reads): conv blocks as `encoder_audio.{i}.block.{0,1}`, the
    projection last, the LSTM in torch's names, the head as `fc1.{0,2}`."""
    convs = sorted({k.split(".")[0] for k in state_dict
                    if k.startswith("conv")}, key=lambda n: int(n[4:]))
    out = {}
    for i, name in enumerate(convs + ["proj"]):
        out[f"encoder_audio.{i}.block.0.weight"] = state_dict[f"{name}.weight"]
        for part in ("weight", "bias", "running_mean", "running_var"):
            out[f"encoder_audio.{i}.block.1.{part}"] = \
                state_dict[f"{name}.bn.{part}"]
    for mine, theirs in (("fwd", "l0"), ("bwd", "l0_reverse")):
        for kind in ("w_ih", "w_hh", "b_ih", "b_hh"):
            torch_kind = ("weight_" if kind[0] == "w" else "bias_") + kind[2:]
            out[f"lstm.{torch_kind}_{theirs}"] = \
                state_dict[f"lstm.{kind}_{mine}"]
    for mine, theirs in (("fc1", "fc1.0"), ("fc2", "fc1.2")):
        for part in ("weight", "bias"):
            out[f"{theirs}.{part}"] = state_dict[f"{mine}.{part}"]
    return {k: v.clone() for k, v in out.items()}


# the port's InpaintNet blocks -> the reference's `stage1` paths
# (`JointModel`, m2 networks.py; `models/torch_import.py` reads them)
INPAINT_PATHS = {"a_in": "down1.0", "a_d1": "down2.0", "a_d2": "down2.1",
                 "b_in": "down3.0", "b_d1": "down4.0", "b_d2": "down4.1",
                 "mid0": "mid.0", "mid1": "mid.1", "mid_dil2": "mid.2",
                 "mid_dil4": "mid.3", "mid_dil8": "mid.4", "mid_dil16": "mid.5",
                 "mid2": "mid.6", "mid3": "mid.7", "mid_up": "mid.8",
                 "up1_conv": "up1.0", "up1_up": "up1.1", "up2_conv": "up2.0",
                 "out": "up2.1"}


def reference_denoiser_state(state_dict):
    """The port's denoiser weights in the reference's `.pth` layout: down
    blocks as `block.{1,2,3}` (conv, BN, PReLU after the reflect pad),
    up blocks as `block.{0,1,2}`, the encoders' blocks as `block.{0,1}`
    with the projection last, the LSTM in torch's names, the head as
    `stage2.fc.{0,2,4}`. Tensors keep their layout (the port's are the
    reference's); PReLU slopes become shape (1,)."""
    out = {}
    for name, path in INPAINT_PATHS.items():
        src, dst = f"inpaint.{name}.", f"stage1.{path}.block."
        conv, bn, act = (0, 1, 2) if name.endswith("_up") else (1, 2, 3)
        out[f"{dst}{conv}.weight"] = state_dict[src + "weight"]
        if name == "out":
            out[f"{dst}{conv}.bias"] = state_dict[src + "bias"]
            continue
        for part in ("weight", "bias", "running_mean", "running_var"):
            out[f"{dst}{bn}.{part}"] = state_dict[f"{src}bn.{part}"]
        out[f"{dst}{act}.weight"] = state_dict[src + "act.weight"].reshape(1)
    for enc in ("x", "n"):
        blocks = sorted({k.split(".")[1] for k in state_dict
                         if k.startswith(f"context.enc_{enc}")
                         and not k.startswith(f"context.enc_{enc}proj")},
                        key=lambda b: int(b[len(f"enc_{enc}"):]))
        for i, block in enumerate(blocks + [f"enc_{enc}proj"]):
            src, dst = f"context.{block}.", f"stage2.encoder_{enc}.{i}.block."
            out[dst + "0.weight"] = state_dict[src + "weight"]
            for part in ("weight", "bias", "running_mean", "running_var"):
                out[f"{dst}1.{part}"] = state_dict[f"{src}bn.{part}"]
    for mine, theirs in (("fwd", "l0"), ("bwd", "l0_reverse")):
        for kind in ("w_ih", "w_hh", "b_ih", "b_hh"):
            torch_kind = ("weight_" if kind[0] == "w" else "bias_") + kind[2:]
            out[f"stage2.lstm.{torch_kind}_{theirs}"] = \
                state_dict[f"context.lstm.{kind}_{mine}"]
    for i in range(3):
        for part in ("weight", "bias"):
            out[f"stage2.fc.{2 * i}.{part}"] = state_dict[f"context.fc{i}.{part}"]
    return {k: v.clone() for k, v in out.items()}


def cli_round_trip(workdir: str, gen: torch.Generator, state_dicts) -> None:
    """Phase 9.4, at full width on the card over a generated corpus:
    `train_joint` (1 epoch, batch 4) writes both stages' `ckpt_epoch1`
    and `latest`; `predict_detector --ckpt latest` -> `bridge` ->
    `predict_denoiser --ckpt latest` give 11 finite metrics (K3 and K4
    launch); `denoise --detector_ckpt latest --denoiser_ckpt latest
    --profile int8` on one WAV calibrates, writes the scale file and
    finite audio (K6 and K7 launch); `import_checkpoint` of the fresh
    detector weights in the reference `.pth` layout as `ckpt_epoch3.pth`
    gives those weights back, and `train_detector --continue --ckpt 3
    --epochs 4` ends with `latest.clock.json` at epoch 4, strict JSON."""
    from sos_tpu_torch.cli import (bridge, denoise, import_checkpoint,
                                   predict_denoiser, predict_detector,
                                   train_detector, train_joint)

    root = os.path.join(workdir, "round_trip")
    ds_json = train_corpus(root, gen)
    noise = os.path.join(root, "noise")
    out = os.path.join(root, "out")
    exp = ["--output_root", out, "--name", "smoke"]

    def model_dir(name, stage):
        return os.path.join(out, f"{name}_{stage}", "model")

    t0 = time.perf_counter()
    run_cli(train_joint, ["--dataset_json", ds_json, "--noise_root", noise,
                          "--batch_size", "4", "--epochs", "1", *exp])
    clocks = {stage: _strict_json(os.path.join(model_dir("smoke", stage),
                                               "latest.clock.json"))
              for stage in ("detector", "denoiser")}
    written = all(os.path.isfile(os.path.join(model_dir("smoke", stage),
                                              f"{n}.pt"))
                  for stage in clocks for n in ("ckpt_epoch1", "latest"))
    log(f"train_joint CLI: {time.perf_counter() - t0:.1f} s, both stages' "
        f"ckpt_epoch1.pt and latest.pt {written}, clocks {clocks}")
    if not (written and all(c["epoch"] == 1 for c in clocks.values())):
        raise RuntimeError("train_joint did not write both stages' epoch")

    t0 = time.perf_counter()
    reset_launches()
    det_out, den_out = (os.path.join(root, "eval", s) for s in ("det", "den"))
    run_cli(predict_detector, ["--dataset_json", ds_json, "--noise_root",
                               noise, "--ckpt", "latest", "--snr_idx", "3",
                               "--outputs", det_out, *exp])
    run_cli(bridge, ["--input_json",
                     os.path.join(det_out, "eval_results_snr0.json"),
                     "--snr", "0"])
    run_cli(predict_denoiser, ["--pred_data",
                               os.path.join(det_out, "pred_data_snr0.json"),
                               "--ckpt", "latest", "--snr", "0",
                               "--outputs", den_out, *exp])
    stats = _strict_json(os.path.join(den_out, "eval_results_snr0.json"))[
        "denoise_statistics"]
    k3 = LAUNCHES["crm_istft"] + LAUNCHES["crm_istft_valid_t"]
    k4 = LAUNCHES["bilstm"] + LAUNCHES["bilstm_lengths"]
    log(f"eval chain on the trained checkpoints (--ckpt latest): "
        f"{time.perf_counter() - t0:.1f} s, {len(stats)} metrics {stats}; "
        f"K3 {k3}, K4 {k4} launches")
    if not (len(stats) == 11 and all(np.isfinite(v) for v in stats.values())
            and k3 and k4):
        raise RuntimeError("eval chain on the trained checkpoints failed")

    t0 = time.perf_counter()
    reset_launches()
    wav, out_wav = (os.path.join(root, "clips", "t0.wav"),
                    os.path.join(root, "denoised.wav"))
    run_cli(denoise, ["--input", wav, "--output", out_wav, "--detector_ckpt",
                      "latest", "--denoiser_ckpt", "latest", "--profile",
                      "int8", *exp])
    scales = os.path.join(model_dir("smoke", "denoiser"),
                          "int8_calibration.json")
    audio = audio_io.read_wav(out_wav)[0]
    k67 = {k: LAUNCHES[k] for k in ("int8_conv", "int8_inpaint")}
    log(f"denoise --profile int8 on the trained checkpoints: "
        f"{time.perf_counter() - t0:.1f} s, scale file "
        f"{os.path.isfile(scales)}, {audio.shape[0]} samples finite "
        f"{bool(np.isfinite(audio).all())}; launches {k67}")
    if not (os.path.isfile(scales) and np.isfinite(audio).all()
            and audio.size and all(k67.values())):
        raise RuntimeError("denoise --profile int8 on the trained "
                           "checkpoints failed")

    t0 = time.perf_counter()
    pth = os.path.join(root, "ckpt_epoch3.pth")
    torch.save({"model_state_dict": reference_detector_state(
        state_dicts["detector"])}, pth)
    imp = ["--output_root", out, "--name", "imported"]
    run_cli(import_checkpoint, ["--stage", "detector", "--pth", pth, *imp])
    got = load_model_state(model_dir("imported", "detector"), "ckpt_epoch3")
    same = got.keys() == state_dicts["detector"].keys() and all(
        torch.equal(got[k], v) for k, v in state_dicts["detector"].items())
    run_cli(train_detector, ["--dataset_json", ds_json, "--noise_root",
                             noise, "--batch_size", "4", "--continue",
                             "--ckpt", "3", "--epochs", "4", *imp])
    clock = _strict_json(os.path.join(model_dir("imported", "detector"),
                                      "latest.clock.json"))
    log(f"import_checkpoint + train_detector --continue --ckpt 3 --epochs "
        f"4: {time.perf_counter() - t0:.1f} s, imported weights exact "
        f"{same}, latest.clock.json {clock}")
    if not (same and clock["epoch"] == 4 and clock["step"] > 0):
        raise RuntimeError("import_checkpoint then --continue failed")


def phase_joint_bf16(cfg: ExperimentConfig, gen: torch.Generator,
                     workdir: str) -> None:
    """Phase 9 (see the module docstring)."""
    t_phase = time.perf_counter()
    state_dicts = fresh_state_dicts(cfg)
    cpu_s = joint_agreement(cfg, state_dicts, gen)
    det_cpu16 = bf16_agreement("detector", cfg, state_dicts["detector"], gen,
                               cpu_s["detector"])
    # the denoiser's CPU bf16 step, estimated from the detector's bf16 and
    # f32 CPU steps and the denoiser's f32 one
    den_est = (cpu_s["denoiser"] * det_cpu16 / cpu_s["detector"]
               if det_cpu16 is not None else float("inf"))
    bf16_agreement("denoiser", cfg, state_dicts["denoiser"], gen, den_est)
    cfg16 = bf16_config(cfg)
    for stage, c, batches in (("joint", cfg, None),
                              ("detector", cfg16, None),
                              ("denoiser", cfg16, (40, 32, 24, 16)),
                              ("joint", cfg16, None)):
        launches = timed_training(stage, c, state_dicts, gen, batches)
        if stage == "joint" and any(
                launches[k] != v * TRAIN_TIMED_STEPS
                for k, v in JOINT_LAUNCHES.items()):
            raise RuntimeError(f"timed joint steps launched {launches}")
    cli_round_trip(workdir, gen, state_dicts)
    log(f"joint and bf16 training phase: {time.perf_counter() - t_phase:.1f} s")


# -- data parallelism and the synthetic eval --------------------------------

# phase 10's device ("cpu" only for a dry run of the phase at small widths)
DEVICE = "cuda"
DP_WORLD = 2          # phase 10 (a): ranks on the one card
DP_LOCAL_BATCH = 2
DP_TIMEOUT_S = 300
SYNTH_PROFILES = ("f32", "bf16", "int8")
SYNTH_SNR_IDX = ("0", "3", "6")
SYNTH_BATCH = 8
SYNTH_BATCHES = 2
# the kernels of a synthetic-eval batch: K2's complement, K2 and one K1
# launch (the device mix and four STFTs), K4 (the denoiser's BiLSTM), K3
# (cRM recover + iSTFT); the int8 profile adds K6 and K7
SYNTH_KERNELS = {
    "f32": ("stft", "mask_gate_complement", "mask_gate", "bilstm",
            "crm_istft"),
    "bf16": ("stft", "mask_gate_complement", "mask_gate", "bilstm",
             "crm_istft"),
    "int8": ("stft", "mask_gate_complement", "mask_gate", "bilstm",
             "crm_istft", "int8_conv", "int8_inpaint"),
}


def dp_step(stage, cfg, state_dict, batch, device):
    """One real train step of `stage` on `device` from `state_dict`
    (within a process group: this process's slice, synced): its metrics,
    the gradients Adam stepped with, the new state and the launches, on
    the CPU."""
    state = _init(stage, cfg, device, state_dict)
    seen = {}

    def keep(optimizer, args, kwargs):
        seen["grads"] = {n: p.grad.detach().cpu().clone()
                         for n, p in state.model.named_parameters()}
    state.optimizer.register_step_pre_hook(keep)
    make = (train_loop.make_detector_train_step if stage == "detector"
            else train_loop.make_denoiser_train_step)
    reset_launches()
    _, metrics = make(cfg, 100)(state, batch)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return {"metrics": metrics, "grads": seen["grads"],
            "launches": dict(LAUNCHES),
            "state": {k: v.detach().cpu().clone()
                      for k, v in state.model.state_dict().items()}}


def dp_worker(rank: int, world: int, port: int, path: str) -> None:
    """A rank of phase 10 (a): a process on the saved device (card 0) in
    a gloo group (NCCL refuses two ranks on one device), one detector and
    one denoiser step on its slice of the saved global batch, in the
    saved config; its results to a file."""
    from sos_tpu_torch.parallel import distributed

    blob = torch.load(os.path.join(path, "inputs.pt"), weights_only=False)
    distributed.initialize(f"127.0.0.1:{port}", world, rank, require=True,
                           device=blob["device"], backend="gloo")
    try:
        cfg = ExperimentConfig.from_json(blob["cfg"])
        n = len(blob["batch"]["snr"]) // world
        local = {k: v[rank * n:(rank + 1) * n]
                 for k, v in blob["batch"].items()}
        out = {stage: dp_step(stage, cfg, blob[stage], local, blob["device"])
               for stage in ("detector", "denoiser")}
        torch.save(out, os.path.join(path, f"rank{rank}.pt"))
    finally:
        distributed.shutdown()


def dp_two_ranks(cfg, gen: torch.Generator, workdir: str) -> None:
    """Phase 10 (a): DP_WORLD ranks on the card over gloo with CUDA
    tensors, each at DP_LOCAL_BATCH, against one process at the global
    batch on the card: the ranks' new states bit-identical; loss within
    1e-4 relative, BatchNorm statistics 1e-5, gradients 5e-2 relative L2
    (phase 8's bounds); K1, K2's complement, K4's training instance and
    K4b launch in every rank."""
    import torch.multiprocessing as mp
    from sos_tpu_torch.parallel.distributed import free_port

    t0 = time.perf_counter()
    path = os.path.join(workdir, "dp_ranks")
    os.makedirs(path)
    inputs = dict(fresh_state_dicts(cfg), cfg=cfg.to_json(),
                  device=f"{DEVICE}:0" if DEVICE == "cuda" else DEVICE,
                  batch=train_batch(DP_WORLD * DP_LOCAL_BATCH, gen))
    torch.save(inputs, os.path.join(path, "inputs.pt"))
    ctx = mp.start_processes(dp_worker,
                             args=(DP_WORLD, free_port(), path),
                             nprocs=DP_WORLD, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + DP_TIMEOUT_S
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            raise RuntimeError(f"the gloo ranks did not finish in "
                               f"{DP_TIMEOUT_S} s")
    ranks = [torch.load(os.path.join(path, f"rank{r}.pt"),
                        weights_only=False) for r in range(DP_WORLD)]
    t_ranks = time.perf_counter() - t0
    for stage in ("detector", "denoiser"):
        one = dp_step(stage, cfg, inputs[stage], inputs["batch"], DEVICE)
        got = ranks[0][stage]
        same = all(torch.equal(got["state"][k], r[stage]["state"][k])
                   for r in ranks[1:] for k in got["state"])
        loss_gap = (abs(got["metrics"]["loss"] - one["metrics"]["loss"])
                    / abs(one["metrics"]["loss"]))
        stats_err = max(float((got["state"][k] - v).abs().max())
                        for k, v in one["state"].items() if "running" in k)
        grad_l2 = _relative_l2(got["grads"], one["grads"])
        launched = [{k: r[stage]["launches"][k] for k in TRAIN_KERNELS[stage]}
                    for r in ranks]
        log(f"data-parallel {stage} step {card_note()}: {DP_WORLD} gloo "
            f"ranks x batch {DP_LOCAL_BATCH} against one process at batch "
            f"{DP_WORLD * DP_LOCAL_BATCH}: ranks' states bit-identical "
            f"{same}; loss {got['metrics']['loss']:.7f} vs "
            f"{one['metrics']['loss']:.7f} (relative {loss_gap:.3e}), BN "
            f"statistics max |diff| {stats_err:.3e}, gradients relative L2 "
            f"{grad_l2:.3e}; launches per rank {launched}")
        if not (same and loss_gap <= 1e-4 and stats_err <= 1e-5
                and grad_l2 <= 5e-2
                and all(all(v > 0 for v in lr.values()) for lr in launched)):
            raise RuntimeError(f"data-parallel {stage} step disagrees")
    log(f"two gloo ranks on the card: {t_ranks:.1f} s (spawned processes "
        f"included), the one-process steps "
        f"{time.perf_counter() - t0 - t_ranks:.1f} s")


def _torchrun_env(port: int):
    return {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}


def dp_nccl_cli(cfg, gen: torch.Generator, workdir: str):
    """Phase 10 (b): NCCL at world size 1 under torchrun's variables:
    `train_denoiser --distributed` for 1 epoch on a generated corpus,
    then `--continue --ckpt latest` to epoch 2 (`latest.clock.json`
    advances, strict JSON); then the synced denoiser step (sync-BN
    all-reduces and the gradient all-reduce) timed at batch 40 beside
    phase 8's plain step. Returns the experiment's flags."""
    from sos_tpu_torch.cli import train_denoiser
    from sos_tpu_torch.parallel import distributed
    from sos_tpu_torch.parallel.distributed import free_port

    root = os.path.join(workdir, "dp_cli")
    ds_json = train_corpus(root, gen)
    exp = ["--output_root", os.path.join(root, "out"), "--name", "smoke"]
    clock_path = os.path.join(root, "out", "smoke_denoiser", "model",
                              "latest.clock.json")
    saved = {k: os.environ.get(k) for k in _torchrun_env(0)}
    clocks = []
    try:
        for extra in (["--epochs", "1"],
                      ["--epochs", "2", "--continue", "--ckpt", "latest"]):
            os.environ.update(_torchrun_env(free_port()))
            t0 = time.perf_counter()
            run_cli(train_denoiser, ["--distributed", "--dataset_json",
                                     ds_json, "--noise_root",
                                     os.path.join(root, "noise"),
                                     "--batch_size", "4", "--device",
                                     DEVICE, *exp, *extra])
            clocks.append(_strict_json(clock_path))
            log(f"train_denoiser --distributed (NCCL, world 1) "
                f"{' '.join(extra)}: {time.perf_counter() - t0:.1f} s, "
                f"latest.clock.json {clocks[-1]}")
            if distributed.is_initialized():
                raise RuntimeError("train_denoiser left its process group")
        if not (clocks[0]["epoch"] == 1 and clocks[0]["step"] > 0
                and clocks[1]["epoch"] == 2
                and clocks[1]["step"] == 2 * clocks[0]["step"]):
            raise RuntimeError(f"train_denoiser --distributed --continue "
                               f"did not advance latest.clock.json: {clocks}")
        key = ("denoiser", cfg.train.compute_dtype, cfg.train.remat,
               TRAIN_BATCH["denoiser"])
        plain_ms = STEP_MS.get(key)
        os.environ.update(_torchrun_env(free_port()))
        distributed.initialize(require=True, device=DEVICE)
        try:
            timed_training("denoiser", cfg, fresh_state_dicts(cfg), gen)
        finally:
            distributed.shutdown()
        synced_ms = STEP_MS[key]
        log(f"synced denoiser step (NCCL, world 1) {card_note()}: batch "
            f"{key[-1]}, median {synced_ms:.1f} ms against phase 8's plain "
            + ("step: not measured in this run" if plain_ms is None else
               f"{plain_ms:.1f} ms: overhead {synced_ms - plain_ms:+.1f} ms "
               f"({(synced_ms / plain_ms - 1) * 100:+.2f} %)"))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return exp


def dp_shard(cfg, det_state, den_state, gen: torch.Generator) -> None:
    """Phase 10 (c): `FusedDenoisePipeline.shard` over every visible card
    against the unsharded call on 8 clips, f32 and int8: equal bits, the
    waveforms within 1e-4 (bit for bit on one card)."""
    devices = ([torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
               if DEVICE == "cuda" else [DEVICE])
    clips = make_clips(SYNTH_BATCH, gen)
    for profile in ("f32", "int8"):
        one = FusedDenoisePipeline(cfg, det_state, den_state, profile=profile,
                                   device=DEVICE)
        shard = FusedDenoisePipeline(cfg, det_state, den_state,
                                     profile=profile,
                                     device=DEVICE).shard(devices)
        y1, b1 = one(clips)
        reset_launches()
        y2, b2 = shard(clips)
        torch.cuda.synchronize()
        err = float((y1 - y2).abs().max())
        log(f"shard over {len(devices)} card(s) {card_note()}, {profile}, "
            f"{SYNTH_BATCH} clips: bits equal {bool(torch.equal(b1, b2))}, "
            f"waveforms bit-identical {bool(torch.equal(y1, y2))} (max "
            f"|diff| {err:.3e}); launches {fused_launches(profile)}")
        if not (torch.equal(b1, b2) and err <= 1e-4):
            raise RuntimeError(f"shard ({profile}) disagrees with the "
                               "unsharded call")


def fused_launches(profile: str):
    keys = (("stft", "bilstm", "mask_gate", "crm_istft") if profile != "int8"
            else ("stft", "bilstm", "mask_gate", "crm_istft", "int8_conv",
                  "int8_inpaint"))
    return {k: LAUNCHES[k] for k in keys}


def synthetic_eval_phase(cfg, gen: torch.Generator, workdir: str,
                         exp) -> None:
    """Phase 10 (d): `eval_synthetic --noisy_baseline` in f32, bf16 and
    int8 on phase 10 (b)'s trained denoiser over a generated corpus, SNR
    indices 0/3/6, batch 8, 2 batches: 11 finite metrics (and their
    noisy baselines) at every SNR, the kernels of SYNTH_KERNELS launched;
    then the device part alone (audio-s/s on the card, median of 3 after
    1) and the host metric seconds of one batch, and one batch of 2 on
    the card against the CPU (f32, within 1e-3)."""
    from sos_tpu_torch.cli import eval_synthetic
    from sos_tpu_torch.data import (DatasetIndex, DenoiserBatcher, NoiseBank,
                                    denoiser_windows)
    from sos_tpu_torch.infer.synthetic_eval import (SyntheticDenoise,
                                                    clip_metrics)

    root = os.path.join(workdir, "synth")
    ds_json = train_corpus(root, gen, seconds=8)
    noise = os.path.join(root, "noise")
    for profile in SYNTH_PROFILES:
        out_json = os.path.join(root, f"report_{profile}.json")
        reset_launches()
        t0 = time.perf_counter()
        run_cli(eval_synthetic, [
            "--dataset_json", ds_json, "--noise_root", noise, "--ckpt",
            "latest", *exp, "--snr_idx", *SYNTH_SNR_IDX, "--batch_size",
            str(SYNTH_BATCH), "--max_batches", str(SYNTH_BATCHES),
            "--noisy_baseline", "--profile", profile, "--out", out_json,
            "--device", DEVICE])
        wall = time.perf_counter() - t0
        report = _strict_json(out_json)
        launched = {k: LAUNCHES[k] for k in SYNTH_KERNELS[profile]}
        ok = len(report) == len(SYNTH_SNR_IDX) and all(
            row["num_clips"] == SYNTH_BATCH * SYNTH_BATCHES
            and sum(k.startswith("avg_") for k in row) == 11
            and sum(k.startswith("noisy_avg_") for k in row) == 11
            and all(np.isfinite(v) for v in row.values())
            for row in report.values())
        log(f"eval_synthetic --profile {profile} {card_note()}: {wall:.1f} s "
            f"for {len(report)} SNRs x {SYNTH_BATCH * SYNTH_BATCHES} clips; "
            + "; ".join(f"{snr}: stoi {row['avg_stoi']:.4f} (noisy "
                        f"{row['noisy_avg_stoi']:.4f}), pesq "
                        f"{row['avg_pesq']:.4f}, ssnr "
                        f"{row['avg_ssnr_regular']:.4f}"
                        for snr, row in report.items())
            + f"; launches {launched}")
        if not (ok and all(v > 0 for v in launched.values())):
            raise RuntimeError(f"eval_synthetic --profile {profile} failed")

    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data,
                                                            snr_idx=3))
    state = load_model_state(os.path.join(exp[1], "smoke_denoiser", "model"),
                             "latest")
    idx = DatasetIndex.load(ds_json)
    windows = denoiser_windows(idx.files, cfg.data.clip_seconds,
                               cfg.data.overlap_seconds)
    bank = NoiseBank.from_roots([noise], cfg.data.sample_rate)
    batch = next(iter(DenoiserBatcher(windows, bank, cfg.data, SYNTH_BATCH,
                                      shuffle=False, seed=0)))
    card = SyntheticDenoise(cfg, state, "f32", noisy_baseline=True,
                            device=DEVICE)
    times = []
    for _ in range(4):
        t0 = time.perf_counter()
        denoised, clean, mixed = card(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    dev_s = statistics.median(times[1:])
    host = [w.cpu().numpy() for w in (denoised, clean, mixed)]
    t0 = time.perf_counter()
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(lambda i: clip_metrics(host[0][i], host[1][i], SR),
                      range(SYNTH_BATCH)))
        list(pool.map(lambda i: clip_metrics(host[2][i], host[1][i], SR),
                      range(SYNTH_BATCH)))
    host_s = time.perf_counter() - t0
    audio_s = SYNTH_BATCH * CLIP / SR
    log(f"synthetic eval f32 {card_note()}: device part {dev_s * 1e3:.1f} "
        f"ms a batch of {SYNTH_BATCH} ({audio_s / dev_s:.1f} audio-s/s); "
        f"host metrics {host_s:.2f} s a batch with the noisy baseline "
        f"({2 * SYNTH_BATCH} clips on 8 threads, "
        f"{2 * audio_s / host_s:.1f} audio-s/s)")
    small = {k: v[:2] for k, v in batch.items()}
    cpu = SyntheticDenoise(cfg, state, "f32", noisy_baseline=True,
                           device="cpu")
    errs = [float((a.cpu() - b).abs().max())
            for a, b in zip(card(small), cpu(small))]
    log(f"synthetic eval f32, card against CPU on 2 clips: max |diff| "
        f"denoised {errs[0]:.3e}, clean {errs[1]:.3e}, mixed {errs[2]:.3e}")
    if max(errs) > 1e-3:
        raise RuntimeError("synthetic eval: card and CPU disagree")


def phase_data_parallel(cfg: ExperimentConfig, det_state, den_state,
                        gen: torch.Generator, workdir: str) -> None:
    """Phase 10 (see the module docstring)."""
    t_phase = time.perf_counter()
    log(f"phase 10: {torch.cuda.device_count()} visible card(s)")
    dp_two_ranks(cfg, gen, workdir)
    exp = dp_nccl_cli(cfg, gen, workdir)
    dp_shard(cfg, det_state, den_state, gen)
    synthetic_eval_phase(cfg, gen, workdir, exp)
    log(f"data-parallel and synthetic eval phase: "
        f"{time.perf_counter() - t_phase:.1f} s")


# -- phase 11: the deployment path --------------------------------------

DEPLOY_NAME = "deploy"
DEPLOY_FILES, DEPLOY_SECONDS = 8, 8.5   # the calibration corpus
DEPLOY_CLIPS = 4                        # clips a calibrate run takes
# (name, profile, batch, clip seconds, wire dtype, rows the CPU checks)
# of the artifacts: the CPU's plain int8 path is slow, so the CPU runs
# the artifact's pipeline on its first rows
ARTIFACTS = (("f32_b16_2s", "f32", 16, 2.0, "float32", 4),
             ("int8_b8_8s", "int8", 8, 8.0, "float32", 1),
             ("int8_b16_2s_int16", "int8", 16, 2.0, "int16", 1))
ARTIFACT_KERNELS = {"f32": ("stft", "crm_istft", "bilstm"),
                    "int8": ("stft", "crm_istft", "bilstm", "int8_conv",
                             "int8_inpaint")}  # and K2, by window
PARITY_SECONDS = (2.0, 2.5, 3.0, 3.5)
# the doctor checks that must be ok on the card's machine; media-tools
# and pesq-backend may warn (ffmpeg and pypesq are not installed there)
DOCTOR_OK = ("accelerator", "compile-cache", "native-engine",
             "experiment/detector", "experiment/denoiser",
             "experiment/int8-calibration")


def deploy_corpus(root: str, gen: torch.Generator):
    """`DEPLOY_FILES` seeded utterances of `DEPLOY_SECONDS` as 14 kHz WAVs
    in `root/corpus`; returns (the directory, the paths)."""
    corpus = os.path.join(root, "corpus")
    os.makedirs(corpus)
    paths = []
    for i in range(DEPLOY_FILES):
        paths.append(os.path.join(corpus, f"c{i}.wav"))
        audio_io.write_wav(paths[-1], utterance(int(DEPLOY_SECONDS * SR), gen),
                           SR)
    return corpus, paths


def detector_bits(cfg, det_state, clips: np.ndarray, threshold, device):
    """The float detector's probabilities and bits on (N, 28000) clips."""
    det = SilenceDetector(cfg.detector)
    det.load_state_dict(det_state)
    det.to(device).eval()
    with torch.no_grad(), exact_fp32():
        prob = torch.sigmoid(det(stft(torch.from_numpy(clips).to(device)),
                                 int(2.0 * cfg.data.frame_rate))).cpu()
    return prob, None if threshold is None else (prob >= threshold).float()


def run_calibrate(argv, expect, what):
    """`calibrate` in this process with the counts set to 0 just before;
    every kernel in `expect` must launch. Returns the counts."""
    from sos_tpu_torch.cli import calibrate
    t0 = time.perf_counter()
    reset_launches()
    run_cli(calibrate, argv)
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    got = {k: counts[k] for k in expect}
    log(f"calibrate {what}: {time.perf_counter() - t0:.1f} s, launches {got}")
    if not all(got.values()):
        raise RuntimeError(f"calibrate {what}: a kernel never launched: {got}")
    return counts


def flat_scales(path: str) -> np.ndarray:
    with open(path) as fp:
        state = json.load(fp)
    den, det = state["denoiser"], state["detector"]
    return np.array(den["enc_x"] + den["enc_n"] + det["conv"]
                    + [den["inpaint"][k] for k in sorted(den["inpaint"])])


def deploy_calibrate(cfg, det_state, root, corpus, paths, flags):
    """Phase 11 (a). Returns (threshold, the 2 s scale file, the K2
    launches of the long-window and despeckle runs)."""
    from sos_tpu_torch.cli.calibrate import chunk_corpus
    clips = chunk_corpus(paths, SR, CLIP, DEPLOY_CLIPS)
    prob, _ = detector_bits(cfg, det_state, clips, None, DEVICE)
    threshold = pick_threshold(prob)
    common = ["--input_dir", corpus, "--threshold", repr(threshold),
              "--batch", str(DEPLOY_CLIPS), "--max_clips", str(DEPLOY_CLIPS)]
    run_calibrate(flags + common, ("stft", "mask_gate", "bilstm"),
                  "2 s on the card")
    scales = os.path.join(root, "out", f"{DEPLOY_NAME}_denoiser", "model",
                          "int8_calibration.json")
    long_counts = run_calibrate(
        flags + common + ["--clip_seconds", "8",
                          "--out", os.path.join(root, "scales_8s.json")],
        ("stft", "mask_gate_long", "bilstm"), "8 s on the card (K2's "
        "gather-map table, 240 frames x 112,000 samples)")
    cfg600 = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, despeckle_min_run=600))
    cfg600_json = os.path.join(root, "despeckle600.json")
    with open(cfg600_json, "w") as fp:
        fp.write(cfg600.to_json())
    desp_counts = run_calibrate(
        flags + common + ["--config_json", cfg600_json,
                          "--out", os.path.join(root, "scales_600.json")],
        ("stft", "mask_gate_despeckle", "bilstm"),
        "2 s, despeckle_min_run 600, on the card (K2's despeckle instance)")
    t0 = time.perf_counter()
    cpu_scales = os.path.join(root, "scales_cpu.json")
    from sos_tpu_torch.cli import calibrate
    run_cli(calibrate, flags + common + ["--out", cpu_scales,
                                         "--device", "cpu"])
    _, bits_card = detector_bits(cfg, det_state, clips, threshold, DEVICE)
    _, bits_cpu = detector_bits(cfg, det_state, clips, threshold, "cpu")
    same_bits = bool(torch.equal(bits_card, bits_cpu))
    card, host = flat_scales(scales), flat_scales(cpu_scales)
    rel = float(np.max(np.abs(card - host) / np.abs(host)))
    log(f"calibrate 2 s on the CPU: {time.perf_counter() - t0:.1f} s; "
        f"threshold {threshold:.6f}, voiced {int(bits_card.sum())}/"
        f"{bits_card.numel()}, min margin "
        f"{float((prob - threshold).abs().min()):.3e}, bits equal "
        f"{same_bits}; {len(card)} scales, max relative |card - cpu| "
        f"{rel:.3e} (tolerance 1e-5)")
    if not (same_bits and rel <= 1e-5):
        raise RuntimeError("calibrate: the card's 2 s scale file disagrees "
                           "with the CPU's")
    return threshold, scales, {
        "mask_gate_long": long_counts["mask_gate_long"],
        "mask_gate_despeckle": desp_counts["mask_gate_despeckle"]}


def program_prob(pipe, x: torch.Tensor) -> torch.Tensor:
    """The detector's probabilities inside a pipeline, on its device."""
    from sos_tpu_torch.infer.fused import _wire_in
    with torch.no_grad(), exact_fp32():
        mixed_cat = pipe._stft(_wire_in(x.to(pipe.device)))
        if pipe._quant_det is not None:
            logits = pipe._quant_det.logits_cat(mixed_cat, pipe.num_frames)
        else:
            logits = pipe.detector.forward_nchw(_nchw(mixed_cat),
                                                pipe.num_frames)
    return torch.sigmoid(logits).cpu()


def deploy_export(cfg, det_state, den_state, root, paths, flags, threshold,
                  scales, gen):
    """Phase 11 (b)."""
    from sos_tpu_torch.cli import export_serving
    from sos_tpu_torch.cli.calibrate import chunk_corpus
    from sos_tpu_torch.infer.export import (export_denoise_program,
                                            load_denoise_program)
    from sos_tpu_torch.infer.fused import wire_decode, wire_encode
    for name, profile, batch, seconds, wire, cpu_rows in ARTIFACTS:
        path = os.path.join(root, f"{name}.pt")
        argv = flags + ["--output", path, "--batch", str(batch),
                        "--clip_seconds", str(seconds), "--threshold",
                        repr(threshold), "--profile", profile,
                        "--transfer_dtype", wire]
        run_cli(export_serving, argv + (["--calibration_json", scales]
                                        if seconds != 2.0 else []))
        t0 = time.perf_counter()
        prog = load_denoise_program(path, device=DEVICE)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        k2 = "mask_gate_long" if seconds > 6.3 else "mask_gate"
        captured = prog.capture_launches
        missing = [k for k in ARTIFACT_KERNELS[profile] + (k2,)
                   if not captured.get(k)]
        x = chunk_corpus(paths, SR, int(seconds * SR), batch)
        if len(x) < batch:
            raise RuntimeError(f"{name}: the corpus gives {len(x)} clips")
        x = wire_encode(x) if wire == "int16" else x
        y, bits = prog(torch.from_numpy(x).to(DEVICE))
        eager = FusedDenoisePipeline(
            cfg, det_state, den_state, threshold=threshold,
            clip_seconds=seconds, profile=profile, wire_dtype=wire,
            calibration_path=scales if profile == "int8" else None,
            device=DEVICE)
        y_e, bits_e = eager(torch.from_numpy(x).to(DEVICE))
        t0 = time.perf_counter()
        host = load_denoise_program(path, device="cpu").pipe
        x_c, bits_k = torch.from_numpy(x[:cpu_rows]), bits[:cpu_rows].cpu()
        y_c, bits_c = host(x_c)
        cpu_s = time.perf_counter() - t0
        eq_c = bool(torch.equal(bits_k, bits_c))
        if not eq_c:  # a frame within 1e-3 of the threshold flipped
            margin = (program_prob(host, x_c) - threshold).abs()
            near = int((bits_k != bits_c).sum())
            eq_c = bool(torch.equal(bits_k[margin > 1e-3],
                                    bits_c[margin > 1e-3]))
            log(f"artifact {name}: {near} bits flipped between the card and "
                f"the CPU, all within 1e-3 of the threshold {eq_c}; the "
                "CPU denoises with the card's bits")
            y_c = host.denoise_with_bits(x_c, bits_k)
        as_f32 = wire_decode if wire == "int16" else np.asarray
        y, y_e, y_c = (as_f32(t.cpu().numpy()) for t in (y, y_e, y_c))
        d_eager = float(np.abs(y - y_e).max())
        d_cpu = float(np.abs(y[:cpu_rows] - y_c).max())
        eq_e = bool(torch.equal(bits.cpu(), bits_e.cpu()))
        log(f"artifact {name} ({os.path.getsize(path) / 1e6:.1f} MB): load "
            f"and capture {load_s:.1f} s, launches at capture {captured}; "
            f"replay against eager on the card: bits equal {eq_e}, max "
            f"|diff| {d_eager:.3e} (tolerance 1e-5); against the artifact "
            f"on the CPU, its first {cpu_rows} rows ({cpu_s:.1f} s): bits "
            f"equal {eq_c}, max |diff| "
            f"{d_cpu:.3e} (tolerance 1e-3); voiced {int(bits.sum())}/"
            f"{bits.numel()}, finite {bool(np.isfinite(y).all())}")
        if missing or not (eq_e and eq_c and d_eager <= 1e-5
                           and d_cpu <= 1e-3 and np.isfinite(y).all()):
            raise RuntimeError(f"artifact {name} failed (kernels not "
                               f"captured: {missing})")
        del prog, eager
        torch.cuda.empty_cache()

    # replay against eager calls at batch 128, 2 s: audio-s/s
    x = make_clips(BATCH, gen).to(DEVICE)
    for profile in ("int8", "bf16"):
        path = os.path.join(root, f"{profile}_b{BATCH}_2s.pt")
        export_denoise_program(cfg, det_state, den_state, path, BATCH,
                               threshold=threshold, profile=profile,
                               calibration_path=scales if profile == "int8"
                               else None)
        prog = load_denoise_program(path, device=DEVICE)
        times = {"replayed": [], "eager": []}
        for _ in range(10):
            for kind, fn in (("replayed", prog), ("eager", prog.pipe)):
                t0 = time.perf_counter()
                fn(x)
                torch.cuda.synchronize()
                times[kind].append(time.perf_counter() - t0)
        med = {k: statistics.median(v) for k, v in times.items()}
        log(f"artifact {profile} b{BATCH} 2 s {card_note()}: median of 10 "
            f"replayed calls {med['replayed'] * 1e3:.2f} ms -> "
            f"{BATCH * CLIP / SR / med['replayed']:.1f} audio-s/s; eager "
            f"calls {med['eager'] * 1e3:.2f} ms -> "
            f"{BATCH * CLIP / SR / med['eager']:.1f} audio-s/s")
        del prog
        torch.cuda.empty_cache()


def deploy_parity(cfg, root: str, gen: torch.Generator) -> None:
    """Phase 11 (d): `parity_check` on full-size fabricated reference
    `.pth` files over 4 short utterances."""
    from sos_tpu_torch.cli import parity_check
    from sos_tpu_torch.models.torch_import import (import_denoiser_checkpoint,
                                                   import_detector_checkpoint)
    det_state = init_state_dict(SilenceDetector(cfg.detector), gen)
    den_state = init_state_dict(JointDenoiser(cfg.denoiser), gen)
    proot = os.path.join(root, "parity")
    for sub in ("clips", "noise"):
        os.makedirs(os.path.join(proot, sub))
    det_pth, den_pth, den_bad = (os.path.join(proot, f) for f in (
        "ckpt_epoch87.pth", "ckpt_epoch24.pth", "ckpt_epoch24_bad.pth"))
    torch.save({"model_state_dict": reference_detector_state(det_state)},
               det_pth)
    ref = reference_denoiser_state(den_state)
    torch.save({"model_state_dict": ref}, den_pth)
    back = (import_detector_checkpoint(det_pth),
            import_denoiser_checkpoint(den_pth))
    if not all(got.keys() == want.keys() and all(
            torch.equal(got[k], v) for k, v in want.items())
            for got, want in zip(back, (det_state, den_state))):
        raise RuntimeError("parity_check: the fabricated .pth files do not "
                           "import back to their weights")
    ref["stage2.fc.4.bias"] = ref["stage2.fc.4.bias"] + 4.0
    torch.save({"model_state_dict": ref}, den_bad)
    files = []
    for i, dur in enumerate(PARITY_SECONDS):
        path = os.path.join(proot, "clips", f"p{i}.wav")
        nsamp = int(dur * SR)
        audio_io.write_wav(path, utterance(nsamp, gen), SR)
        centres = (np.arange(int(dur * 30)) + 0.5) / 30.0
        files.append({"path": path, "audio_path": path, "framerate": 30,
                      "audio_sample_rate": SR, "audio_samples": nsamp,
                      "duration": dur, "num_frames": int(dur * 30),
                      "bit_stream": "".join(
                          "1" if np.sin(2 * np.pi * 1.5 * c) > 0 else "0"
                          for c in centres)})
    for i in range(2):
        audio_io.write_wav(os.path.join(proot, "noise", f"n{i}.wav"),
                           (torch.randn(8 * SR, generator=gen) * 0.1).numpy(),
                           SR)
    ds = os.path.join(proot, "ds.json")
    with open(ds, "w") as fp:
        json.dump({"dataset_path": os.path.join(proot, "clips"),
                   "num_videos": len(files), "files": files}, fp)
    outputs = os.path.join(proot, "out")

    def run(den_path, extra):
        argv = ["--detector_pth", det_pth, "--denoiser_pth", den_path,
                "--dataset_json", ds, "--noise_root",
                os.path.join(proot, "noise"), "--output_root",
                os.path.join(proot, "model_output"), "--name", "parity",
                "--outputs", outputs, "--snr_idx", "3", "--device", DEVICE] + extra
        t0 = time.perf_counter()
        try:
            run_cli(parity_check, argv)
            code = 0
        except SystemExit as e:
            code = e.code
        return code, time.perf_counter() - t0

    code, secs = run(den_pth, [])
    manifest = os.path.join(proot, "manifest.json")
    with open(os.path.join(outputs, "eval_results_snr0.json")) as fp:
        stats = json.load(fp)["denoise_statistics"]
    with open(manifest, "w") as fp:
        json.dump({"denoise_statistics": stats}, fp)
    finite = len(stats) == 11 and all(np.isfinite(v) for v in stats.values())
    code_same, _ = run(den_pth, ["--manifest", manifest])
    code_bad, _ = run(den_bad, ["--manifest", manifest])
    log(f"parity_check (full-size fabricated .pth, {len(files)} utterances, "
        f"{secs:.1f} s a run): statistics finite {finite} {stats}; its own "
        f"output as manifest: exit {code_same}; one perturbed tensor "
        f"(stage2.fc.4.bias + 4): exit {code_bad}")
    if not (code == 0 and finite and code_same == 0 and code_bad == 1):
        raise RuntimeError("parity_check failed its controls")


def deploy_doctor_and_dispatcher(out: str) -> None:
    """Phase 11 (c) and (e)."""
    import contextlib
    import io
    from sos_tpu_torch.cli import doctor
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            run_cli(doctor, ["--json", "--output_root", out, "--name",
                             DEPLOY_NAME, "--device", DEVICE])
            code = 0
        except SystemExit as e:
            code = e.code
    report = json.loads(buf.getvalue().strip().splitlines()[-1])
    status = {c["name"]: c["status"] for c in report["checks"]}
    log(f"doctor --json: exit {code}, " + "; ".join(
        f"{c['name']} {c['status']}: {c['detail']}" for c in report["checks"]))
    if code != 0 or any(status.get(k) != "ok" for k in DOCTOR_OK):
        raise RuntimeError(f"doctor: {status}")
    repo = os.path.dirname(os.path.abspath(__file__))
    helped = subprocess.run([sys.executable, "-m", "sos_tpu_torch", "--help"],
                            capture_output=True, text=True, timeout=120,
                            cwd=repo)
    listed = [line.split()[0] for line in helped.stdout.splitlines()
              if line.startswith("  ")]
    dispatched = subprocess.run(
        [sys.executable, "-m", "sos_tpu_torch", "doctor", "--json",
         "--output_root", out, "--name", DEPLOY_NAME, "--device", DEVICE],
        capture_output=True, text=True, timeout=300, cwd=repo)
    if not dispatched.stdout.strip():
        raise RuntimeError("python -m sos_tpu_torch doctor printed nothing: "
                           + dispatched.stderr[-2000:])
    ok = json.loads(dispatched.stdout.strip().splitlines()[-1])["ok"]
    log(f"python -m sos_tpu_torch --help: exit {helped.returncode}, "
        f"{len(listed)} commands {listed}; python -m sos_tpu_torch doctor "
        f"--json: exit {dispatched.returncode}, ok {ok}")
    if helped.returncode != 0 or "calibrate" not in listed or \
            dispatched.returncode != 0 or not ok:
        raise RuntimeError("the python -m sos_tpu_torch dispatcher failed")


def deploy_native(paths) -> None:
    """Phase 11 (f): the engine builds here, and its threaded decode gives
    the Python decoder's samples exactly."""
    from sos_tpu_torch.runtime import NativeAudioEngine, engine, native_available
    t0 = time.perf_counter()
    if not native_available():
        raise RuntimeError("the native audio engine did not build")
    eng = NativeAudioEngine(num_threads=4)
    build_s = time.perf_counter() - t0
    n_max = max(eng.info(p)[0] for p in paths)
    buf, lengths = eng.load_batch(paths, SR, n_max)
    exact = all(np.array_equal(buf[i, :lengths[i]], audio_io.load(p, sr=SR)[0])
                for i, p in enumerate(paths))
    log(f"native engine {engine.library_path().name}: built and loaded in "
        f"{build_s:.1f} s; load_batch of {len(paths)} files equals the "
        f"Python decode exactly {exact}")
    if not exact:
        raise RuntimeError("the native engine's decode differs")


def phase_deployment(cfg: ExperimentConfig, det_state, den_state,
                     gen: torch.Generator, workdir: str):
    """Phase 11 (see the module docstring). Returns the launches of K2's
    long-window and despeckle cases on this path."""
    t_phase = time.perf_counter()
    root = os.path.join(workdir, "deploy")
    out = os.path.join(root, "out")
    for stage, state in (("detector", det_state), ("denoiser", den_state)):
        model_dir = os.path.join(out, f"{DEPLOY_NAME}_{stage}", "model")
        os.makedirs(model_dir)
        torch.save({"model": state}, os.path.join(model_dir, "latest.pt"))
    corpus, paths = deploy_corpus(root, gen)
    flags = ["--output_root", out, "--name", DEPLOY_NAME, "--device", DEVICE]
    deploy_native(paths)
    threshold, scales, k2_launches = deploy_calibrate(
        cfg, det_state, root, corpus, paths, flags)
    deploy_export(cfg, det_state, den_state, root, paths, flags, threshold,
                  scales, gen)
    deploy_doctor_and_dispatcher(out)
    deploy_parity(cfg, root, gen)
    log(f"deployment phase: {time.perf_counter() - t_phase:.1f} s")
    return k2_launches


# -- phase 12: the training tools and other STFT geometries ---------------

TOOLS_SRS = (44100, 14000)    # (a) the generated corpus's sample rates
TOOLS_BATCH = 4               # (b) fit: batch and steps
TOOLS_STEPS = 2
QUANT_BATCH = 16              # (d) the bf16-InpaintNet mode's batch
QUANT_CPU_ROWS = 2            # (d) rows calibrated and compared on the CPU
GEOMETRY_BATCH = 16           # (e) the pipelines' batch
GEOMETRY_CPU_ROWS = 2         # (e) rows the CPU runs (f32); int8: 1
OTHER_GEOMETRIES = ((1022, 256, 1022), (254, 64, 254))
# (e) the bf16 detector's confidences against f32's (seen 6.4e-5 at
# n_fft 1022, full width)
BF16_PROB_BOUND = 1e-3
# (e) the length-bucketed predictor at the second geometry
GEOMETRY_BUCKETS = (256, 512, 1024)
GEOMETRY_SECONDS = (1.5, 2.0, 3.0, 4.5)  # T <= 1,024 frames at hop 64


class RecordingWriter:
    """A tensorboard writer that keeps each image's tag, shape and step."""

    def __init__(self):
        self.images = []

    def add_image(self, tag, img, global_step=None):
        self.images.append((tag, tuple(img.shape), global_step))


class ListBatches:
    """A batcher over a fixed list of batches, as `fit` iterates one."""

    def __init__(self, batches):
        self.batches = batches

    def set_epoch(self, epoch):
        pass

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def run_dispatcher(argv):
    """`python -m sos_tpu_torch <argv>` in this process: (exit code,
    standard output)."""
    import contextlib
    import io

    from sos_tpu_torch import __main__ as dispatcher

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = dispatcher.main(list(argv))
    return rc, buf.getvalue()


def tools_preprocess(root: str, gen: torch.Generator) -> None:
    """(a) `preprocess --label_silence` on WAVs at 44.1 and 14 kHz; each
    bitstream against `label_bitstream` on the decoded, resampled WAV."""
    from sos_tpu_torch.data.index import DatasetIndex
    from sos_tpu_torch.data.preprocess import CANONICAL_SR, label_bitstream

    wavs = os.path.join(root, "wavs")
    os.makedirs(wavs)
    for i, sr in enumerate(TOOLS_SRS * 2):
        n = int(sr * (1.5 + 0.5 * i))
        quiet = (np.arange(n) // (sr // 2)) % 2 == 1  # every other 0.5 s
        y = utterance(n, gen) * np.where(quiet, 0.02, 1.0)
        audio_io.write_wav(os.path.join(wavs, f"u{i}_{sr}.wav"),
                           y.astype(np.float32), sr)
    out_json = os.path.join(root, "ds.json")
    t0 = time.perf_counter()
    rc, out = run_dispatcher(["preprocess", "--audio_dir", wavs,
                              "--output_json", out_json, "--label_silence"])
    secs = time.perf_counter() - t0
    index = DatasetIndex.load(out_json)
    for rec in index.files:
        y, sr = audio_io.load(rec.audio_path, sr=None, mono=True)
        if sr != CANONICAL_SR:
            y = audio_io.resample(y, sr, CANONICAL_SR)
        want = label_bitstream(y, CANONICAL_SR).ljust(
            rec.num_frames, "1")[:rec.num_frames]
        if rec.bit_stream != want or set(want) != {"0", "1"}:
            raise RuntimeError(f"preprocess: {rec.audio_path} bitstream "
                               "differs from label_bitstream")
    log(f"phase 12 (a) preprocess (host work, no device): {out.strip()} in "
        f"{secs:.2f} s; {index.num_files} records read back, each bitstream "
        "equal to label_bitstream on the decoded WAV "
        f"({', '.join(str(f.num_frames) for f in index.files)} frames)")
    if rc != 0 or index.num_files != 2 * len(TOOLS_SRS):
        raise RuntimeError("preprocess: wrong exit code or record count")


def tools_fit(cfg: ExperimentConfig, root: str, gen: torch.Generator) -> str:
    """(b) `fit` at full width with `visualize_hook`: the denoiser for
    TOOLS_STEPS steps at TOOLS_BATCH, visualize_frequency 1, a recording
    writer. Returns the log directory."""
    import importlib.util

    from sos_tpu_torch.train import visualize
    from sos_tpu_torch.train.fit import fit
    from sos_tpu_torch.train.state import TrainClock

    render = importlib.util.find_spec("matplotlib") is not None
    log("phase 12 (b): matplotlib "
        + ("imports here: the panels are rendered" if render else
           "is not installed here: the panel waveforms are checked, not "
           "rendered"))
    tcfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, nr_epochs=1, batch_size=TOOLS_BATCH, visualize_frequency=1))
    _, state = train_loop.init_denoiser_state(tcfg, device="cuda", seed=SEED)
    writer, calls = RecordingWriter(), []
    # the hook the port ships renders; beside it, its panel waveforms on
    # the card are held against the same call on the CPU
    render_hook = visualize.make_denoiser_visualize_hook(tcfg)

    def hook(train_writer, st, batch, step):
        before = LAUNCHES["crm_istft"]
        waves = visualize.denoiser_batch_panels(tcfg, st.model, batch)
        torch.cuda.synchronize()
        k3 = LAUNCHES["crm_istft"] - before
        if render:
            render_hook(writer, st, batch, step)
        diff = None
        if not calls:  # the same call on the CPU, first item
            host = JointDenoiser(tcfg.denoiser)
            host.load_state_dict({k: v.cpu() for k, v in
                                  st.model.state_dict().items()})
            waves_c = visualize.denoiser_batch_panels(
                tcfg, host, {k: v[:1] for k, v in batch.items()})
            diff = max(float((waves[k].cpu() - waves_c[k]).abs().max())
                       for k in visualize.PANELS)
        calls.append((step, k3, diff, {k: tuple(v.shape)
                                       for k, v in waves.items()}))

    log_dir = os.path.join(root, "fit", "log")
    batches = [train_batch(TOOLS_BATCH, gen) for _ in range(TOOLS_STEPS)]
    t0 = time.perf_counter()
    fit(tcfg, state, TrainClock(), train_loop.make_denoiser_train_step(
        tcfg, TOOLS_STEPS), train_loop.make_denoiser_eval_step(tcfg),
        ListBatches(batches), ListBatches([]),
        os.path.join(root, "fit", "model"), log_dir, visualize_hook=hook)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    for step, k3, diff, shapes in calls:
        log(f"phase 12 (b) visualize_hook at step {step}: crm_istft "
            f"launches {k3}, panels {shapes}"
            + ("" if diff is None else
               f", max |card - cpu| over the panels {diff:.3e} (tolerance "
               "1e-3)"))
    log(f"phase 12 (b) fit: {TOOLS_STEPS} denoiser steps at batch "
        f"{TOOLS_BATCH}, full width, with the hook, {secs:.2f} s; images "
        f"written {[(t, shp, st) for t, shp, st in writer.images]} "
        f"{card_note()}")
    if [c[0] for c in calls] != list(range(TOOLS_STEPS)):
        raise RuntimeError(f"fit: the hook fired at {[c[0] for c in calls]}")
    if any(c[1] == 0 for c in calls) or not calls[0][2] <= 1e-3:
        raise RuntimeError("fit: the hook's panels missed K3 or disagree "
                           "with the CPU")
    if render and len(writer.images) != TOOLS_STEPS:
        raise RuntimeError("fit: the hook rendered no image")
    return log_dir


def tools_report(workdir: str, log_dir: str) -> None:
    """(c) `report` on phase 7's eval outputs and (b)'s metrics log."""
    import re

    for argv in (["--results_dir", os.path.join(workdir, "eval", "det")],
                 ["--results_dir", os.path.join(workdir, "eval", "den")],
                 ["--train_log", log_dir]):
        rc, out = run_dispatcher(["report"] + argv)
        log(f"phase 12 (c) report {' '.join(argv)}: exit {rc}")
        for line in out.strip().splitlines():
            log(f"    {line}")
        numbers = re.findall(r"(?<![A-Za-z_])[-+]?(?:\d+\.\d+|nan|inf)", out)
        if rc != 0 or not numbers or not all(np.isfinite(float(v))
                                             for v in numbers):
            raise RuntimeError(f"report {argv}: no finite table")


def tools_bf16_inpaint(cfg: ExperimentConfig, den_state,
                       gen: torch.Generator) -> None:
    """(d) `QuantizedDenoiser(inpaint_dtype="bfloat16")` at full width:
    int8 trunks (K6), bf16 InpaintNet on cuDNN (no K7); card against CPU
    on the first QUANT_CPU_ROWS rows, both calibrated on those rows;
    timed beside the int8 mode at QUANT_BATCH."""
    from sos_tpu_torch.models.quant import QuantizedDenoiser

    x = make_clips(QUANT_BATCH, gen)
    gate = (torch.arange(CLIP) % 7000 < 3500).float()
    mixed, gated = stft(x.cuda()), stft((x * gate).cuda())
    rows = QUANT_CPU_ROWS
    timings = {}
    for mode in ("bfloat16", "int8"):
        q = QuantizedDenoiser(cfg.denoiser, den_state, inpaint_dtype=mode)
        q.calibrate([(mixed[:rows], gated[:rows])])
        reset_launches()
        noise, crm = q(mixed, gated)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            q(mixed, gated)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        timings[mode] = statistics.median(times)
        if mode == "bfloat16":
            card_scales = q.calibration_state()
            host = QuantizedDenoiser(cfg.denoiser, den_state,
                                     inpaint_dtype=mode, device="cpu")
            t0 = time.perf_counter()
            host.calibrate([(mixed[:rows].cpu(), gated[:rows].cpu())])
            _, crm_host = host(mixed[:rows].cpu(), gated[:rows].cpu())
            host_s = time.perf_counter() - t0
            scale_gap = max(abs(a / b - 1) for key in card_scales
                            for a, b in zip(card_scales[key],
                                            host.calibration_state()[key]))
            diff = float((crm[:rows].cpu() - crm_host).abs().max())
            log(f"phase 12 (d) QuantizedDenoiser(inpaint_dtype='bfloat16'), "
                f"full width, {QUANT_BATCH} x 2 s: launches int8_conv "
                f"{launches['int8_conv']}, int8_inpaint "
                f"{launches['int8_inpaint']}; scales {sorted(card_scales)}, "
                f"card against CPU relative gap {scale_gap:.3e}; cRM "
                f"{tuple(crm.shape)} max |card - cpu| over {rows} rows "
                f"{diff:.3e} (tolerance 1e-3; the CPU's calibrate + call "
                f"{host_s:.1f} s)")
            if (launches["int8_conv"] == 0 or launches["int8_inpaint"] != 0
                    or not diff <= 1e-3
                    or not bool(torch.isfinite(crm).all())):
                raise RuntimeError("bf16 InpaintNet mode: wrong kernels or "
                                   "card and CPU disagree")
        elif launches["int8_inpaint"] == 0:
            raise RuntimeError("int8 InpaintNet mode never launched K7")
    log(f"phase 12 (d) median of 5 calls at {QUANT_BATCH} x 2 s: "
        f"inpaint_dtype bfloat16 {timings['bfloat16']:.2f} ms, int8 "
        f"{timings['int8']:.2f} ms {card_note()}")


def geometry_config(cfg: ExperimentConfig, n_fft: int, hop: int,
                    win: int) -> ExperimentConfig:
    """`cfg` at another STFT geometry, both models at its bins."""
    bins = n_fft // 2 + 1
    return dataclasses.replace(
        cfg, stft=StftConfig(n_fft, hop, win),
        detector=dataclasses.replace(cfg.detector, freq_bins=bins),
        denoiser=dataclasses.replace(cfg.denoiser, freq_bins=bins))


def median_call_ms(pipe, x) -> float:
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        pipe(x)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def geometry_agreement(label, card, host, x, prob, rows):
    """The card pipeline against the CPU one on the first `rows` clips:
    bits equal off the threshold (those within 1e-4 reported), waveform
    within 1e-3 on the same bits. Returns the card's (y, bits)."""
    y, bits = card(x)
    y_host, bits_host = host(x[:rows].cpu())
    margin = (prob[:rows].cpu() - card.threshold).abs()
    clear = margin > 1e-4
    bits_c = bits[:rows].cpu()
    if not torch.equal(bits_c[clear], bits_host[clear]):
        raise RuntimeError(f"{label}: card and CPU bits differ off the "
                           "threshold")
    y_cmp = (y[:rows].cpu() if torch.equal(bits_c, bits_host) else
             card.denoise_with_bits(x[:rows], bits_host.cuda()).cpu())
    diff = float((y_cmp - y_host).abs().max())
    log(f"phase 12 (e) {label}: waveform {tuple(y.shape)} finite "
        f"{bool(torch.isfinite(y).all())}, max |card - cpu| over {rows} "
        f"rows {diff:.3e} (tolerance 1e-3), bits equal "
        f"{bool(torch.equal(bits_c, bits_host))}, frames within 1e-4 of "
        f"the threshold {int((~clear).sum())}, voiced "
        f"{int(bits.sum())}/{bits.numel()}")
    if not diff <= 1e-3 or not bool(torch.isfinite(y).all()):
        raise RuntimeError(f"{label}: card and CPU disagree")
    return y, bits


def tools_geometries(cfg: ExperimentConfig, det_state, den_state,
                     gen: torch.Generator, workdir: str):
    """(e) the pipelines at other STFT geometries (see the module
    docstring). Returns the "fft" and generic instances' launches."""
    x = make_clips(GEOMETRY_BATCH, gen).cuda()
    base = FusedDenoisePipeline(cfg, det_state, den_state)
    base(x)
    torch.cuda.synchronize()
    base_ms = median_call_ms(base, x)
    del base
    audio_s = GEOMETRY_BATCH * CLIP / float(SR)
    log(f"phase 12 (e) f32 at the default geometry (510, 158, 400): "
        f"{base_ms:.2f} ms a call of {GEOMETRY_BATCH} x 2 s, "
        f"{audio_s / base_ms * 1e3:.1f} audio-s/s {card_note()}")
    counts = {}
    for index, (nf, hop, win) in enumerate(OTHER_GEOMETRIES):
        instance = kernel_instance(nf, hop, win)
        other = "generic" if instance == "fft" else "fft"
        gcfg = geometry_config(cfg, nf, hop, win)
        det_g = init_state_dict(SilenceDetector(gcfg.detector), gen)
        den_g = init_state_dict(JointDenoiser(gcfg.denoiser), gen)
        geo = f"({nf}, {hop}, {win}), {nf // 2 + 1} bins"
        card = FusedDenoisePipeline(gcfg, det_g, den_g)
        host = FusedDenoisePipeline(gcfg, det_g, den_g, device="cpu")
        with torch.no_grad():
            prob = torch.sigmoid(card.detector(stft(x, nf, hop, win)))
        card.threshold = host.threshold = pick_threshold(prob)
        reset_launches()
        y, bits = geometry_agreement(f"f32 at {geo}", card, host, x, prob,
                                     GEOMETRY_CPU_ROWS)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        for key in (f"stft_{instance}", f"crm_istft_{instance}"):
            counts[key] = counts.get(key, 0) + launches[key]
        log(f"phase 12 (e) f32 at {geo} launches: {launches}")
        if (launches[f"stft_{instance}"] == 0
                or launches[f"crm_istft_{instance}"] == 0
                or launches["stft"] or launches["crm_istft"]
                or launches[f"stft_{other}"] or launches[f"crm_istft_{other}"]):
            raise RuntimeError(f"f32 at {geo}: not the {instance} instances")
        ms = median_call_ms(card, x)
        log(f"phase 12 (e) f32 at {geo}: {ms:.2f} ms a call, "
            f"{audio_s / ms * 1e3:.1f} audio-s/s (the default geometry "
            f"{audio_s / base_ms * 1e3:.1f}) {card_note()}")
        if index == 0:
            geometry_profiles(gcfg, det_g, den_g, card, x, y, bits, prob,
                              workdir, audio_s)
        counts.update(geometry_bucketed(gcfg, den_g, gen))
        del card, host
        torch.cuda.empty_cache()
    return counts


def geometry_profiles(gcfg, det_g, den_g, card, x, y, bits, prob, workdir,
                      audio_s) -> None:
    """(e) bf16 and int8 at the first other geometry."""
    nf = gcfg.stft.n_fft
    bf16 = FusedDenoisePipeline(gcfg, det_g, den_g, profile="bf16",
                                threshold=card.threshold)
    y_b, bits_b = bf16(x)
    with torch.no_grad():
        prob_b = torch.sigmoid(bf16.detector(stft(
            x, nf, gcfg.stft.hop_length, gcfg.stft.win_length)))
    agree = float((bits_b == bits).float().mean())
    # random weights crowd the confidences about the threshold (phase 7's
    # 98 % agreement does not carry over), so the confidences are held:
    # bf16 within BF16_PROB_BOUND of f32. The pipeline's bits must equal
    # f32's on every frame farther than that drift from the threshold
    # (implied by the drift where the pipeline's bits are its detector's
    # confidences thresholded: that is what it checks), and at least half
    # the frames must be that far, so that the drift decides them
    drift = float((prob_b - prob).abs().max())
    clear = (prob - card.threshold).abs() > drift
    p5, p95 = (float(v) for v in torch.quantile(
        prob.flatten().double(), torch.tensor([0.05, 0.95]).double().cuda()))
    y_bb = bf16.denoise_with_bits(x, bits)
    rel = float((y_bb - y).norm() / y.norm())
    ms = median_call_ms(bf16, x)
    log(f"phase 12 (e) bf16 at n_fft {nf}: max |p bf16 - p f32| "
        f"{drift:.3e} (bound {BF16_PROB_BOUND}; f32's confidences span "
        f"{p5:.4f}-{p95:.4f}, 5th-95th percentile); bits agree with f32 "
        f"on {agree:.4f} of frames, on all {int(clear.sum())} of "
        f"{clear.numel()} farther than that drift from the threshold "
        f"{bool(torch.equal(bits_b[clear], bits[clear]))}; waveform on the "
        f"f32 bits relative L2 {rel:.3e} (bound 2e-2), finite "
        f"{bool(torch.isfinite(y_b).all())}; {ms:.2f} ms a call, "
        f"{audio_s / ms * 1e3:.1f} audio-s/s {card_note()}")
    if (not drift <= BF16_PROB_BOUND or not rel <= 2e-2
            or not torch.equal(bits_b[clear], bits[clear])
            or 2 * int(clear.sum()) < clear.numel()
            or not bool(torch.isfinite(y_b).all())):
        raise RuntimeError(f"bf16 at n_fft {nf}: outside its bounds")
    del bf16
    path = os.path.join(workdir, f"int8_calibration_{nf}.json")
    int8 = FusedDenoisePipeline(gcfg, det_g, den_g, profile="int8",
                                threshold=card.threshold,
                                calibration_path=path)
    reset_launches()
    int8(x)  # the first batch calibrates and writes the scale file
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    host = FusedDenoisePipeline(gcfg, det_g, den_g, profile="int8",
                                threshold=card.threshold,
                                calibration_path=path, device="cpu")
    with torch.no_grad():
        prob_i = torch.sigmoid(int8._quant_det.logits_cat(
            stft_cat(x, nf, gcfg.stft.hop_length, gcfg.stft.win_length),
            int8.num_frames))
    geometry_agreement(f"int8 at n_fft {nf}", int8, host, x, prob_i, 1)
    ms = median_call_ms(int8, x)
    instance = kernel_instance(nf, gcfg.stft.hop_length, gcfg.stft.win_length)
    log(f"phase 12 (e) int8 at n_fft {nf}: K6 and K7 take F = "
        f"{nf // 2 + 1}: launches int8_conv {launches['int8_conv']}, "
        f"int8_inpaint {launches['int8_inpaint']}, stft_{instance} "
        f"{launches[f'stft_{instance}']}, crm_istft_{instance} "
        f"{launches[f'crm_istft_{instance}']}; {ms:.2f} ms a call, "
        f"{audio_s / ms * 1e3:.1f} audio-s/s {card_note()}")
    if not all(launches[k] for k in ("int8_conv", "int8_inpaint",
                                      f"stft_{instance}",
                                      f"crm_istft_{instance}")):
        raise RuntimeError(f"int8 at n_fft {nf}: a kernel never launched")


def geometry_bucketed(gcfg, den_g, gen):
    """(e) the length-bucketed denoiser at another geometry: K1
    center=False and K3 with per-row valid_t on the geometry's instances
    ("fft" or generic); the card against the CPU on the shortest
    utterance."""
    from sos_tpu_torch.infer import DenoiserPredictor

    wavs = [utterance(int(s * SR), gen) for s in GEOMETRY_SECONDS]
    bits = ["".join("1" if (j // 15) % 2 == 0 else "0"
                    for j in range(int(s * 30))) for s in GEOMETRY_SECONDS]
    card = DenoiserPredictor(gcfg, den_g, buckets=GEOMETRY_BUCKETS)
    reset_launches()
    out = card.denoise_batch(wavs, bits, batch_size=EVAL_BATCH,
                             keys=("denoised",))
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    instance = kernel_instance(gcfg.stft.n_fft, gcfg.stft.hop_length,
                               gcfg.stft.win_length)
    k1, k3 = f"stft_{instance}_center_false", f"crm_istft_{instance}_valid_t"
    host = DenoiserPredictor(gcfg, den_g, buckets=GEOMETRY_BUCKETS,
                             device="cpu")
    ref = host.denoise_batch(wavs[:1], bits[:1], keys=("denoised",))
    diff = float(np.abs(np.asarray(out[0]["denoised"])
                        - np.asarray(ref[0]["denoised"])).max())
    log(f"phase 12 (e) bucketed denoiser at ({gcfg.stft.n_fft}, "
        f"{gcfg.stft.hop_length}, {gcfg.stft.win_length}), buckets "
        f"{GEOMETRY_BUCKETS}, {len(wavs)} utterances of "
        f"{GEOMETRY_SECONDS} s: launches {k1} {launches[k1]}, {k3} "
        f"{launches[k3]}; the {GEOMETRY_SECONDS[0]} s utterance max |card - "
        f"cpu| {diff:.3e} (tolerance 1e-3)")
    if not launches[k1] or not launches[k3] or not diff <= 1e-3:
        raise RuntimeError(f"bucketed denoiser at another geometry: {k1} or "
                           f"{k3} never launched or the card disagrees")
    return {k: launches[k] for k in (k1, k3)}


def phase_tools_and_geometries(cfg: ExperimentConfig, det_state, den_state,
                               workdir: str):
    """Phase 12 (see the module docstring). Returns the "fft" and
    generic instances' launches."""
    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 12)
    root = os.path.join(workdir, "tools")
    os.makedirs(root)
    tools_preprocess(root, gen)
    log_dir = tools_fit(cfg, root, gen)
    tools_report(workdir, log_dir)
    tools_bf16_inpaint(cfg, den_state, gen)
    counts = tools_geometries(cfg, det_state, den_state, gen, workdir)
    log(f"phase 12: {time.perf_counter() - t_phase:.1f} s")
    return counts


# -- phase 13: the BiLSTM past H 224 and the fast profile ------------------

WIDE_HIDDEN = 256  # both stages' lstm_hidden: the wide route of K4 and K4b
# what a full-width f32 call at that hidden size must launch
WIDE_MAIN_KERNELS = ("stft", "mask_gate", "crm_istft", "bilstm_wide")


def phase_wide_and_fast(gen: torch.Generator, workdir: str) -> dict:
    """13. `ExperimentConfig()` with both stages' `lstm_hidden` at 256 and
    every other width at its default, fresh seeded weights: one f32
    `FusedDenoisePipeline` call at batch 2, card against CPU (phase 4's
    1e-3, equal bits off the threshold; K4's wide route must launch), and
    one denoiser train step at batch 2, card against CPU as phases 8-9
    hold a step (loss 1e-4 relative, gradients 5e-2 relative L2; the wide
    route's training instance and K4b must launch). Then
    `fast_denoiser_config()` (the noise encoder at 64 channels): one f32
    and one int8 call at batch 1 against the CPU path (the int8 one
    calibrating on the CPU into a scale file of its own). Returns the
    wide route's launches on its main path."""
    t_phase = time.perf_counter()
    cfg = ExperimentConfig(
        detector=dataclasses.replace(DetectorModelConfig(),
                                     lstm_hidden=WIDE_HIDDEN),
        denoiser=dataclasses.replace(DenoiserModelConfig(),
                                     lstm_hidden=WIDE_HIDDEN))
    det_state = init_state_dict(SilenceDetector(cfg.detector), gen)
    den_state = init_state_dict(JointDenoiser(cfg.denoiser), gen)
    label = f" at lstm_hidden {WIDE_HIDDEN}"
    launches = phase_main_path(cfg, det_state, den_state, gen, "f32",
                               workdir, kernels=WIDE_MAIN_KERNELS,
                               label=label)
    state_dicts = fresh_state_dicts(cfg)
    _, _, train = train_agreement("denoiser", cfg, state_dicts["denoiser"],
                                  gen, runs=("card", "cpu"), label=label)
    fast = ExperimentConfig(denoiser=fast_denoiser_config())
    det_fast = init_state_dict(SilenceDetector(fast.detector), gen)
    den_fast = init_state_dict(JointDenoiser(fast.denoiser), gen)
    for profile in ("f32", "int8"):
        phase_main_path(fast, det_fast, den_fast, gen, profile, workdir,
                        clips=1, kernels=MAIN_PATH_KERNELS[profile],
                        label=" at fast_denoiser_config()",
                        scale_file="int8_calibration_fast.json")
    log(f"phase 13: {time.perf_counter() - t_phase:.1f} s {card_note()}")
    return {"bilstm_wide": launches["bilstm_wide"],
            "bilstm_train_wide": train["bilstm_train_wide"],
            "bilstm_bwd_wide": train["bilstm_bwd_wide"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
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
        launches.update({k: int8_launches[k] for k in
                         ("int8_conv", "int8_inpaint", *INT8_K6_ENTRIES)},
                        int8_gemm=k5_launches)
        phase_throughput(cfg, det_state, den_state, gen)
        phase_serving(cfg, det_state, den_state, gen, workdir)
        eval_launches = phase_eval(cfg, det_state, den_state, gen, workdir)
        launches.update({k: eval_launches[k]
                         for k in EVAL_KERNELS + INT8_EVAL_KERNELS})
        train_launches = phase_training(cfg, gen, workdir)
        launches.update({k: train_launches[k] for k in
                         ("bilstm_train", "bilstm_bwd",
                          "mask_gate_complement")})
        phase_joint_bf16(cfg, gen, workdir)
        phase_data_parallel(cfg, det_state, den_state, gen, workdir)
        launches.update(phase_deployment(cfg, det_state, den_state, gen,
                                         workdir))
        launches.update(phase_tools_and_geometries(cfg, det_state, den_state,
                                                   workdir))
        launches.update(phase_wide_and_fast(gen, workdir))
        for row in rows:
            row["launches"] = launches[row["name"]]
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")

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
