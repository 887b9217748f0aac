#!/usr/bin/env python3
"""int8 length-bucketed detection against the int8 exact mode over
several seeds on one card, with the CPU's plain path as a second witness.

    python3 scripts/int8_bucket_seeds.py [--seeds 0-7] [--out FILE]

For each seed: a full-width detector with random weights drawn from the
seed (`init_state_dict`), 24 utterances of 1.5-11 s drawn from it as
`chip_smoke.py` phase 7 draws its corpus (2.0 and 7.4 s first; tone
bursts in noise, mixed with a second noise at 0 dB), one int8
calibration on the first utterance on the card, shared by every
predictor, then `DetectorPredictor(profile="int8")` bucketed (buckets
256/512/1024, tiles of 8) and exact, each twice. It reports the largest
confidence difference between the modes (`sos_tpu`'s bound: 2e-5), the
frame where it lies, and whether the repeats are bit-identical. For each
utterance over 5e-6 (the worst three of a seed):

* the frames where the modes' two nearest-resize rules part (the exact
  mode's floor(j * (T / frames)) in float64, the bucketed mode's
  floor(j * T / frames) in integers, both `sos_tpu`'s);
* the same utterance through the f32 profile, bucketed and exact: a
  cause in the float head moves both profiles, one in the int8 trunk
  only the int8 one;
* the int8 codes of the trunk's quantized input that differ between the
  modes over the valid frames, and how far each differing code's value
  x / scale lies from its rounding boundary .5. The trunk is exact
  integer arithmetic from those codes on, so with no differing code the
  modes' confidences differ only in the float head;
* the same utterance through the CPU's plain path (the port's reference
  versions of K1, K6 and K4), bucketed and exact, with the same scales.

The card's name and power limit come first; then a line a seed, and the
results as JSON in FILE (default `chiprun_out/int8_bucket_seeds.json`).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sos_tpu_torch.config import ExperimentConfig  # noqa: E402
from sos_tpu_torch.infer import DetectorPredictor  # noqa: E402
from sos_tpu_torch.models import SilenceDetector, quant  # noqa: E402
from sos_tpu_torch.models.layers import init_state_dict  # noqa: E402
from chip_smoke import resize_ties  # noqa: E402

SR = 14000
BUCKETS = (256, 512, 1024)
TILE = 8
COUNT = 24
BOUND = 2e-5  # sos_tpu's int8 bucketed-against-exact bound on confidences
WITNESS = 5e-6  # utterances over this get the witnesses


def corpus(gen: torch.Generator):
    """24 utterances (2.0 s, 7.4 s, then 1.5-11 s) of tone bursts in
    noise, each mixed with a second noise at 0 dB -> (waves, frames)."""
    rest = 1.5 + torch.rand(COUNT - 2, generator=gen).numpy() * 9.5
    waves, frames = [], []
    for dur in [2.0, 7.4] + [float(d) for d in rest]:
        n = int(dur * SR)
        t = torch.arange(n) / float(SR)
        gate = (torch.sin(2 * np.pi * 1.5 * t) > 0).float()
        clean = (0.4 * torch.sin(2 * np.pi * 220.0 * t) * gate
                 + torch.randn(n, generator=gen) * 0.05)
        noise = torch.randn(n, generator=gen) * 0.1
        noise = noise * (clean.pow(2).mean() / noise.pow(2).mean()).sqrt()
        waves.append((clean + noise).numpy().astype(np.float32))
        frames.append(int(dur * 30))
    return waves, frames


def predictor(cfg, state, scales, buckets, device):
    pred = DetectorPredictor(cfg, state, buckets=buckets, profile="int8",
                             device=device)
    pred._quant.load_calibration(scales)
    return pred


def confidences(pred, waves, frames):
    if pred.buckets is None:
        return [pred.predict_waveform(w, n)[1] for w, n in zip(waves, frames)]
    return [c for _, c in pred.predict_batch(waves, frames, batch_size=TILE)]


def quantized_input(pred, wave, frames):
    """The trunk's float input and int8 codes of one utterance alone
    (NHWC, batch 1), as `_run_encoder_int8` quantizes them, and the
    confidences."""
    seen = []
    original = quant._quantize_act

    def record(x, scale):
        q = original(x, scale)
        if not seen:
            seen.append((x.detach().float().cpu(), q.cpu(), scale))
        return q
    quant._quantize_act = record
    try:
        conf = pred.predict_waveform(wave, frames)[1]
    finally:
        quant._quantize_act = original
    return seen[0], conf


def code_flips(pred_b, pred_e, wave, frames, hop):
    """Codes that differ between the modes over the valid frames, and the
    distance of each differing code's x / scale from .5 -> (that, the
    exact mode's confidences)."""
    (xb, qb, scale), cb = quantized_input(pred_b, wave, frames)
    (xe, qe, _), ce = quantized_input(pred_e, wave, frames)
    valid_t = 1 + len(wave) // hop
    assert xe.shape[2] == valid_t, (xe.shape, valid_t)
    xb, qb = xb[:, :, :valid_t], qb[:, :, :valid_t]
    flips = qb != qe
    ratio = xe[flips].double() / scale
    dist = (ratio - torch.floor(ratio) - 0.5).abs()
    return {"input_max_abs_diff": float((xb - xe).abs().max()),
            "codes": int(qe.numel()), "codes_differing": int(flips.sum()),
            "flip_distance_from_half_max":
                float(dist.max()) if len(dist) else None,
            "flip_code_step_max": int((qb.int() - qe.int()).abs().max()),
            "alone_conf_max_abs_diff": float(np.abs(cb - ce).max())}, ce


def run_seed(cfg, seed: int) -> dict:
    gen = torch.Generator().manual_seed(seed)
    state = init_state_dict(SilenceDetector(cfg.detector), gen)
    waves, frames = corpus(gen)
    cal = DetectorPredictor(cfg, state, profile="int8")
    cal._maybe_calibrate(waves[0])
    scales = cal._quant.calibration_state()
    card = {m: predictor(cfg, state, scales, b, "cuda")
            for m, b in (("bucketed", BUCKETS), ("exact", None))}
    runs = [{m: confidences(p, waves, frames) for m, p in card.items()}
            for _ in range(2)]
    repeat_equal = all(np.array_equal(a, b) for m in card
                       for a, b in zip(runs[0][m], runs[1][m]))
    diffs = [np.abs(b - e) for b, e in zip(runs[0]["bucketed"],
                                           runs[0]["exact"])]
    worst = [float(d.max()) for d in diffs]
    over = sorted((i for i, w in enumerate(worst) if w > WITNESS),
                  key=lambda i: -worst[i])[:3]
    out = {"seed": seed, "max_abs_diff": max(worst),
           "utterances_over_bound": sum(w > BOUND for w in worst),
           "repeat_bit_identical": repeat_equal, "witness": []}
    hop = cfg.stft.hop_length
    cpu = {m: predictor(cfg, state, scales, b, "cpu")
           for m, b in (("bucketed", BUCKETS), ("exact", None))} if over else {}
    f32 = {m: DetectorPredictor(cfg, state, buckets=b, device="cuda")
           for m, b in (("bucketed", BUCKETS), ("exact", None))} if over else {}
    for i in over:
        w, n = waves[i], frames[i]
        f32_conf = [confidences(f32[m], [w], [n])[0]
                    for m in ("bucketed", "exact")]
        item = {"utterance": i, "seconds": len(w) / SR,
                "max_abs_diff": worst[i],
                "at_frame": int(np.argmax(diffs[i])), "frames": n,
                "resize_ties": resize_ties(1 + len(w) // hop, n),
                "f32_max_abs_diff": float(np.abs(f32_conf[0]
                                                 - f32_conf[1]).max()),
                "card": code_flips(card["bucketed"], card["exact"], w, n,
                                   hop)[0]}
        item["cpu"], ce = code_flips(cpu["bucketed"], cpu["exact"], w, n, hop)
        item["cpu"]["card_against_cpu_exact"] = float(
            np.abs(runs[0]["exact"][i] - ce).max())
        out["witness"].append(item)
    return out


def seeds_arg(text: str):
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=seeds_arg, default=seeds_arg("0-7"))
    ap.add_argument("--out", default="chiprun_out/int8_bucket_seeds.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("int8_bucket_seeds: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    cfg = ExperimentConfig()
    results = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        res = run_seed(cfg, seed)
        res["seconds"] = time.perf_counter() - t0
        results.append(res)
        print(json.dumps(res), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fp:
        json.dump(results, fp, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
