#!/usr/bin/env python3
"""How far the card's f32 train step lies from the CPU's, over batches,
repeats and cuDNN's modes, at full width on one card: the spread that
`chip_smoke.py`'s train-step agreement (phases 8 and 9) holds to its
bounds.

    python3 scripts/train_agreement_spread.py [--seeds 4] [--repeats 40]
        [--kink-seeds 0] [--out FILE]

For each seed and stage (denoiser, then detector): a seeded batch of 2
clips (`chip_smoke.train_batch`) through the joint step's device stage
on the card (`joint.joint_inputs`), one CPU step on a copy of those
inputs, then card steps from the same weights on the same inputs: three
as configured, three with `cudnn.benchmark` (cuDNN times its algorithms
and takes the fastest) and two with `cudnn.deterministic`. Each card
step is held to the CPU's as `chip_smoke.train_agreement` holds it: the
loss's relative gap, the relative L2 of all gradients and whether the
update was applied; the relative L2 against the first card step shows
the card's own spread. Then the BiLSTM's and heads' gradients on the
card (K4's training instance and K4b) from the first card step's
features and logits' gradient, `--repeats` times: each repeat must be
bit-identical to the first.

With `--kink-seeds N`, for N more seeds of each stage (joint-step
inputs, one card step for the head's features and logits' gradient): the
BiLSTM's and heads' gradients card against CPU twice, each side taking
its own ReLU signs and the CPU taking the card's
(`chip_smoke.head_agreement`), with the ReLU units whose signs differ
and how close to 0 they lie. It shows what moves the first comparison
past its 1e-3 tolerance.

The card's name and power limit come first; then a line a step, and the
results as JSON in FILE (default `chiprun_out/train_agreement_spread.json`).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from sos_tpu_torch.config import ExperimentConfig  # noqa: E402
from sos_tpu_torch.models.layers import exact_fp32  # noqa: E402

# (label, cudnn.benchmark, cudnn.deterministic) of each card step
CARD_MODES = ((("default", False, False),) * 3
              + (("benchmark", True, False),) * 3
              + (("deterministic", False, True),) * 2)


def card_step(stage, cfg, state_dict, batch, inputs, bench, det):
    state = cs._init(stage, cfg, "cuda", state_dict)
    torch.backends.cudnn.benchmark = bench
    torch.backends.cudnn.deterministic = det
    try:
        out = cs.step_with_gradients(stage, cfg, state, batch, inputs)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.deterministic = False
    return out


def spread(stage, cfg, state_dict, seed, repeats):
    batch = cs.train_batch(2, torch.Generator().manual_seed(1000 + seed))
    with exact_fp32():
        card_in = cs.joint_stage_inputs(stage)(cfg, batch, "cuda")
    fixed = {k: v.cpu() for k, v in card_in.items()}
    l_cpu, g_cpu, _, _ = cs.step_with_gradients(
        stage, cfg, cs._init(stage, cfg, "cpu", state_dict), batch, fixed)
    steps, first = [], None
    for mode, bench, det in CARD_MODES:
        loss, grads, applied, head = card_step(stage, cfg, state_dict, batch,
                                               card_in, bench, det)
        _, l2 = cs._gradient_spread(grads, g_cpu)
        rec = {"stage": stage, "seed": seed, "mode": mode, "loss": loss,
               "loss_cpu": l_cpu, "rel": abs(loss - l_cpu) / abs(l_cpu),
               "l2": l2, "applied": applied,
               "l2_vs_first_card": (None if first is None else
                                    cs._gradient_spread(grads, first[0])[1])}
        first = first or (grads, head)
        print(json.dumps(rec), flush=True)
        steps.append(rec)
    x, g = first[1]["x"], first[1]["g"]
    ref = cs.head_gradients(stage, cfg, state_dict, "cuda", x, g)[0]
    differing = sum(
        any(not torch.equal(v, ref[k]) for k, v in cs.head_gradients(
            stage, cfg, state_dict, "cuda", x, g)[0].items())
        for _ in range(repeats))
    print(f"{stage} seed {seed}: BiLSTM and heads on the card, {repeats} "
          f"repeats, {differing} not bit-identical to the first", flush=True)
    return steps, {"stage": stage, "seed": seed, "repeats": repeats,
                   "differing": differing}


def kinks(stage, cfg, state_dict, seed):
    """The head's gradients card against CPU from one card step's head
    features: each side on its own ReLU signs, then the CPU on the
    card's."""
    batch = cs.train_batch(2, torch.Generator().manual_seed(2000 + seed))
    with exact_fp32():
        card_in = cs.joint_stage_inputs(stage)(cfg, batch, "cuda")
    _, _, _, head = card_step(stage, cfg, state_dict, batch, card_in, False,
                              False)
    x, g = head["x"], head["g"]
    own, _ = cs._gradient_spread(
        cs.head_gradients(stage, cfg, state_dict, "cuda", x, g)[0],
        cs.head_gradients(stage, cfg, state_dict, "cpu", x, g)[0])
    head = cs.head_agreement(stage, cfg, state_dict, x, g)
    rec = {"stage": stage, "seed": seed,
           "own_signs": max(own.values()), "own_worst": max(own, key=own.get),
           "card_signs": head["errs"][head["worst"]],
           "card_worst": head["worst"], "kinks": head["kinks"],
           "widest": head["widest"], "z_gap": head["gap"],
           "nearest": head["nearest"]}
    print(json.dumps(rec), flush=True)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--repeats", type=int, default=40)
    ap.add_argument("--kink-seeds", type=int, default=0)
    ap.add_argument("--out", default="chiprun_out/train_agreement_spread.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_agreement_spread: no CUDA device", file=sys.stderr)
        return 1
    cs.phase_card()
    cs.phase_build()
    cfg = ExperimentConfig()
    state_dicts = cs.fresh_state_dicts(cfg)
    steps, repeats = [], []
    for stage in ("denoiser", "detector"):
        for seed in range(args.seeds):
            s, r = spread(stage, cfg, state_dicts[stage], seed, args.repeats)
            steps += s
            repeats.append(r)
    heads = [kinks(stage, cfg, state_dicts[stage], seed)
             for stage in ("denoiser", "detector")
             for seed in range(args.kink_seeds)]
    for stage in ("denoiser", "detector"):
        mine = [h for h in heads if h["stage"] == stage]
        if not mine:
            continue
        over = [h for h in mine if h["own_signs"] > 1e-3]
        print(f"{stage} [{cs.CARD}]: BiLSTM and heads over {len(mine)} "
              f"seeds, card against CPU: on their own ReLU signs worst "
              f"{max(h['own_signs'] for h in mine):.3e}, over 1e-3 in "
              f"{len(over)} (with differing signs in "
              f"{sum(h['kinks'] > 0 for h in over)}); differing signs in "
              f"{sum(h['kinks'] > 0 for h in mine)} seeds, within "
              f"{max(h['widest'] for h in mine):.3e} of 0; on the card's "
              f"signs worst {max(h['card_signs'] for h in mine):.3e}; "
              f"pre-activations apart by "
              f"{max(h['z_gap'] for h in mine):.3e} of their max at most, "
              f"nearest to 0 {min(h['nearest'] for h in mine):.3e} at "
              f"least",
              flush=True)
    for stage in ("denoiser", "detector"):
        mine = [s for s in steps if s["stage"] == stage]
        if not mine:
            continue
        print(f"{stage} [{cs.CARD}]: {len(mine)} card steps, gradients' "
              f"relative L2 to the CPU {min(s['l2'] for s in mine):.3e}-"
              f"{max(s['l2'] for s in mine):.3e}, the card's own "
              f"{max(s['l2_vs_first_card'] or 0 for s in mine):.3e} at most, "
              f"loss gap {max(s['rel'] for s in mine):.3e} at most, all "
              f"applied {all(s['applied'] for s in mine)}", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": cs.CARD, "steps": steps, "repeats": repeats,
                   "kinks": heads}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
