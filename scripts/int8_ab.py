#!/usr/bin/env python3
"""Time the int8 profile's main-path kernels and call in two checkouts of
`sos_tpu_torch`, in turns on one card: A, B, B, A.

    python3 scripts/int8_ab.py OTHER_CHECKOUT [LABEL_A LABEL_B]

OTHER_CHECKOUT is a directory holding another version of the package
(`git archive <commit> sos_tpu_torch | tar -x -C DIR`); the checkout this
script lies in is B. Each turn is a process of its own, which imports
the package from its checkout and builds its kernels. A turn times, at
128 clips with CUDA events (20 calls after 50 ms of warm-up calls), K7
at seven full-width InpaintNet blocks and K6 at four trunk blocks, the
shapes `chip_smoke.py` phase 3 times, and K6 at every first-layer and
projection shape of the int8 main path (the Cin = 2 1x7 blocks and the
1x1 float32 projections, the detector's at 60 frames), then the median
of 10 calls of `FusedDenoisePipeline(profile="int8")` on 128 seeded 2 s
clips (self-calibrated on the card on its first call) and one more call
under `torch.profiler`, whose K6 device time it splits by route (the
Hopper tile, the first-layer and projection kernels, the `mma.sync`
gather's first layers, projections and other shapes), with the launches
of each K6 entry point in that call. Then the length-bucketed (valid
width) cases of `chip_smoke.py` phase 3 at 8 rows of a 1,024-frame
bucket with fixed per-row widths (`VALID_WIDTHS`): K6 at its first layer
and at enc_x block 7 on the tile, K7 at four InpaintNet blocks, each
with those widths, with every row full and without widths (the unmasked
instance), and `DenoiserPredictor(profile="int8", buckets=(256, 512,
1024))`'s `denoise_batch` over 24 seeded utterances of 1.5-11 s in
tiles of 8 (phase 7's int8 bucketed denoise; self-calibrated on the
card, median of 3 passes after one), with the chain's fill. It prints
three lines a turn and the card's name and power limit first. Compare
two versions only within one run: two runs may land on two cards.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys
import tempfile
import time

# (label, kind, k, stride, dilation, Cin, Cout, H, W)
K7_CASES = (
    ("a_in", "down", 5, 1, 1, 2, 64, 256, 178),
    ("a_d1", "down", 5, 2, 1, 64, 128, 256, 178),
    ("mid_dil16", "down", 3, 1, 16, 256, 256, 64, 45),
    ("mid_up", "up", 3, 2, 1, 256, 128, 64, 45),
    ("a_d2", "down", 5, 1, 1, 128, 128, 128, 89),
    ("mid_dil2", "down", 3, 1, 2, 256, 256, 64, 45),
    ("up2_conv", "down", 3, 1, 1, 128, 64, 256, 178),
)
# (label, Cin, Cout, kernel, dilation, float32 out, T) at F 256: the
# four of phase 3's K6 sum, then the other first-layer and projection
# shapes of the int8 main path (det0 is also enc_n's block 0)
K6_CASES = (
    ("enc_x0", 2, 96, (1, 7), (1, 1), False, 178),
    ("enc_x7", 96, 96, (5, 5), (32, 1), False, 178),
    ("det10", 48, 48, (5, 5), (4, 4), False, 178),
    ("proj", 96, 8, (1, 1), (1, 1), True, 178),
    ("det0", 2, 48, (1, 7), (1, 1), False, 178),
    ("enc_n_proj", 48, 4, (1, 1), (1, 1), True, 178),
    ("det_proj_t60", 48, 8, (1, 1), (1, 1), True, 60),
)
# K6's device time by route: the first entry whose words all occur in a
# kernel's name (the gather's instances name their loader and epilogue:
# ConvA<false, ...SamePad> is the Cin = 2 byte gather, EpiFloat the
# projection)
K6_ROUTES = (
    ("tile", ("conv_halo_s8",)),
    ("first layer", ("conv_first_s8",)),
    ("projection", ("conv_proj_s8",)),
    ("gather first layer", ("ConvA<false", "SamePad")),
    ("gather projection", ("EpiFloat", "SamePad")),
    ("gather other", ("SamePad",)),
)
BATCH = 128
# phase 3's valid-width cases at a 1,024-frame bucket: (label, Cin, Cout,
# kernel, dilation) of K6 at F 256; (label, kind, k, stride, dilation,
# Cin, Cout, H, W) of K7
K6_VALID = (("enc_x0", 2, 96, (1, 7), (1, 1)),
            ("enc_x7", 96, 96, (5, 5), (32, 1)))
K7_VALID = (
    ("a_in", "down", 5, 1, 1, 2, 64, 256, 1024),
    ("a_d1", "down", 5, 2, 1, 64, 128, 256, 1024),
    ("mid_dil16", "down", 3, 1, 16, 256, 256, 64, 256),
    ("mid_up", "up", 3, 2, 1, 256, 128, 64, 256),
)
# per-row widths (frames) of the 8 rows: 5,937 of 8,192, the valid
# columns of phase 3's K6 case in earlier runs; K7's narrower blocks take
# them scaled to their width
VALID_WIDTHS = (1024, 918, 877, 640, 571, 764, 530, 613)
EVAL_BUCKETS = (256, 512, 1024)
EVAL_COUNT = 24


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


def turn(label: str) -> None:
    import torch

    from sos_tpu_torch.config import ExperimentConfig
    from sos_tpu_torch.infer.fused import FusedDenoisePipeline
    from sos_tpu_torch.kernels import library
    from sos_tpu_torch.models import JointDenoiser, SilenceDetector
    from sos_tpu_torch.models.layers import init_state_dict
    from sos_tpu_torch.ops.int8_conv import conv_same_int8, inpaint_conv_int8

    library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def weights(cout, taps):
        w = torch.randint(-127, 128, (cout, -(-taps // 64) * 64),
                          generator=gen, device=dev, dtype=torch.int8)
        w[:, taps:] = 0
        return w, torch.full((cout,), 1e-3, device=dev), \
            torch.zeros(cout, device=dev)

    def x_of(shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    times = []
    alpha = torch.tensor([0.25], device=dev)
    for name, kind, k, s, d, cin, cout, h, w in K7_CASES:
        wq, ws, b = weights(cout, k * k * cin)
        x = x_of((BATCH, h, w, cin))
        times.append((name, event_ms(lambda: inpaint_conv_int8(
            x, wq, ws, b, alpha, kind, k, s, d))))
    for name, cin, cout, ks, dil, f32, t in K6_CASES:
        wq, ws, b = weights(cout, ks[0] * ks[1] * cin)
        x = x_of((BATCH, 256, t, cin))
        times.append((name, event_ms(lambda: conv_same_int8(
            x, wq, ws, b, ks, dil, f32))))
    cfg = ExperimentConfig()
    cpu = torch.Generator().manual_seed(0)
    det = init_state_dict(SilenceDetector(cfg.detector), cpu)
    den = init_state_dict(JointDenoiser(cfg.denoiser), cpu)
    pipe = FusedDenoisePipeline(cfg, det, den, profile="int8")
    clips = (torch.randn(BATCH, 28000, generator=cpu) * 0.2).to(dev)
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
        routes, launches = k6_routes(lambda: pipe(clips))
    med = statistics.median(calls)
    print(f"{label}: " + " ".join(f"{n} {t:.4f} ms" for n, t in times)
          + f"; int8 call {med:.1f} ms ({BATCH * 2.0 / med * 1e3:.1f} "
          "audio-s/s)", flush=True)
    print(f"{label} K6 in one profiled int8 call: " + ", ".join(
        f"{n} {ms:.3f} ms ({k} kernels)" for n, (ms, k) in routes.items())
        + "; launches " + ", ".join(f"{n} {c}" for n, c in launches.items()),
        flush=True)
    valid_turn(label, cfg, den, weights, x_of)


def valid_turn(label, cfg, den_state, weights, x_of) -> None:
    """The valid-width cases and the int8 bucketed denoise of one turn."""
    import numpy as np
    import torch

    from sos_tpu_torch.infer import DenoiserPredictor
    from sos_tpu_torch.ops.int8_conv import conv_same_int8, inpaint_conv_int8

    dev = torch.device("cuda")
    rows = len(VALID_WIDTHS)
    times = []
    for name, cin, cout, ks, dil in K6_VALID:
        wq, ws, b = weights(cout, ks[0] * ks[1] * cin)
        x = x_of((rows, 256, 1024, cin))
        for tag, vt in (("", VALID_WIDTHS), (" full", (1024,) * rows),
                        (" unmasked", None)):
            vt = None if vt is None else torch.tensor(vt, device=dev)
            times.append((name + tag, event_ms(lambda: conv_same_int8(
                x, wq, ws, b, ks, dil, valid_t=vt))))
    alpha = torch.tensor([0.25], device=dev)
    for name, kind, k, s, d, cin, cout, h, w in K7_VALID:
        wq, ws, b = weights(cout, k * k * cin)
        x = x_of((rows, h, w, cin))
        scaled = tuple(-(-v * w // 1024) for v in VALID_WIDTHS)
        for tag, vt in (("", scaled), (" full", (w,) * rows),
                        (" unmasked", None)):
            vt = None if vt is None else torch.tensor(vt, device=dev)
            times.append((name + tag, event_ms(lambda: inpaint_conv_int8(
                x, wq, ws, b, alpha, kind, k, s, d, valid_t=vt))))
    print(f"{label} valid-width cases (8 rows, widths {VALID_WIDTHS} of "
          "1024, K7 scaled to its width): " + " ".join(
              f"{n} {t:.4f} ms" for n, t in times), flush=True)

    rng = np.random.default_rng(0)
    sr, hop = cfg.data.sample_rate, cfg.stft.hop_length
    seconds = 1.5 + rng.random(EVAL_COUNT) * 9.5
    wavs = [(rng.standard_normal(int(t * sr)) * 0.1).astype(np.float32)
            for t in seconds]
    bits = ["".join("1" if np.sin(2 * np.pi * 1.5 * (j + 0.5) / 30) > 0
                    else "0" for j in range(int(t * 30))) for t in seconds]
    with tempfile.TemporaryDirectory() as tmp:
        pred = DenoiserPredictor(
            cfg, den_state, buckets=EVAL_BUCKETS, profile="int8",
            calibration_path=os.path.join(tmp, "int8_calibration.json"))
        passes = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pred.denoise_batch(wavs, bits, batch_size=8, keys=("denoised",))
            torch.cuda.synchronize()
            passes.append(time.perf_counter() - t0)
    valid = [1 + len(wv) // hop for wv in wavs]
    groups = {}
    for v in valid:
        bucket = next((b for b in EVAL_BUCKETS if v <= b), v)
        groups.setdefault(bucket, []).append(v)
    tiles = sum(-(-len(g) // 8) * 8 * bucket for bucket, g in groups.items())
    med = statistics.median(passes[1:])
    print(f"{label} int8 bucketed denoise: {sum(seconds) / med:.1f} "
          f"audio-s/s (median {med:.3f} s of passes "
          + ", ".join(f"{p:.3f}" for p in passes[1:])
          + f"; fill {sum(valid) / tiles:.4f}, {sum(valid)} of {tiles} "
          "frames)", flush=True)


def k6_routes(call):
    """K6's device ms and kernel count by route in one `call`, from
    torch.profiler, and the launches of each K6 entry point in it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sos_tpu_torch.kernels import ENTRY_LAUNCHES, reset_launches

    torch.cuda.synchronize()
    reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    launches = {n: c for n, c in ENTRY_LAUNCHES.items()
                if n.startswith("sos_int8_conv_") and "inpaint" not in n}
    routes = {name: [0.0, 0] for name, _ in K6_ROUTES}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for name, keys in K6_ROUTES:
            if all(k in evt.key for k in keys):
                us = getattr(evt, "self_device_time_total", None)
                if us is None:
                    us = evt.self_cuda_time_total
                routes[name][0] += us / 1e3
                routes[name][1] += evt.count
                break
    return {n: tuple(v) for n, v in routes.items()}, launches


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--turn":
        turn(sys.argv[2])
        return 0
    if len(sys.argv) not in (2, 4):
        print(__doc__, file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    other = os.path.abspath(sys.argv[1])
    names = sys.argv[2:] or ["A", "B"]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    for root, name in ((other, names[0]), (here, names[1]), (here, names[1]),
                       (other, names[0])):
        env = dict(os.environ, PYTHONPATH=root)
        subprocess.run([sys.executable, "-P", os.path.abspath(__file__),
                        "--turn", name], cwd=root, env=env, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
