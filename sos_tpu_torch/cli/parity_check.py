"""Real-checkpoint parity harness: released .pth -> end-to-end -> deltas.

Usage (the day the released reference checkpoints are on disk):
    python -m sos_tpu_torch parity_check \
        --detector_pth ckpt_epoch87.pth --denoiser_pth ckpt_epoch24.pth \
        --dataset_json data/test.json --noise_root noise/ --snr_idx 3 \
        --manifest reference_eval_results_snr0.json \
        [--tolerance 0.01] [--outputs parity_out] [--out report.json] \
        [--device cuda|cpu]

(Port of `sos_tpu/cli/parity_check.py`.) One command for the parity bar
(PESQ/STOI within 0.01 of the reference run with the released
`ckpt_epoch87.pth`/`ckpt_epoch24.pth`):

  1. imports both PyTorch checkpoints directly
     (models/torch_import.py — no separate import step needed),
  2. runs the full two-stage pipeline exactly as the reference demo
     does: detector eval (mixing corpus noise at the chosen SNR, seeded
     noise assignment) -> bridge -> denoiser eval at the 16 kHz metric
     rate, on the card unless given `--device cpu`,
  3. compares the resulting `denoise_statistics` against `--manifest` —
     the reference run's own stage-2 `eval_results*.json` (the same
     schema) or any JSON with bare `avg_*` keys,
  4. prints the per-metric delta table and exits 1 when |avg_pesq
     delta| or |avg_stoi delta| exceeds `--tolerance` (2 when the
     manifest lacks either).

Without `--manifest` it still runs the pipeline and prints this run's
statistics (use that to CREATE a manifest from a reference run's
output, or to eyeball a checkpoint).
"""

import argparse
import dataclasses
import json
import os
import sys

from sos_tpu_torch.cli.common import (add_common_train_args,
                                      experiment_dirs,
                                      train_config_from_args)


def _manifest_stats(path: str) -> dict:
    with open(path) as fp:
        payload = json.load(fp)
    stats = payload.get("denoise_statistics", payload)
    if not any(k.startswith("avg_") for k in stats):
        raise ValueError(
            f"manifest {path}: expected a 'denoise_statistics' dict or "
            "bare 'avg_*' keys (the stage-2 eval_results schema, "
            "reference m2 predict.py:556-575)")
    return {k: float(v) for k, v in stats.items() if k.startswith("avg_")}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_train_args(parser)
    parser.add_argument("--detector_pth", type=str, required=True,
                        help="released stage-1 checkpoint (ckpt_epoch87.pth)")
    parser.add_argument("--denoiser_pth", type=str, required=True,
                        help="released stage-2 checkpoint (ckpt_epoch24.pth)")
    parser.add_argument("--manifest", type=str, default=None,
                        help="reference run's stage-2 eval_results*.json "
                             "(or bare avg_* dict) to diff against")
    parser.add_argument("--snr_idx", type=int, default=3,
                        help="index into the SNR set (default 3 = 0 dB)")
    parser.add_argument("--threshold", type=float, default=0.5)
    parser.add_argument("--tolerance", type=float, default=0.01,
                        help="max |delta| for avg_pesq and avg_stoi")
    parser.add_argument("--outputs", type=str, default=None,
                        help="working dir for the intermediate artifacts "
                             "(default: <exp>/outputs)")
    parser.add_argument("--out", type=str, default=None,
                        help="write the delta report JSON here")
    args = parser.parse_args(argv)

    # Read the manifest BEFORE running the pipeline: evaluate_denoiser
    # writes eval_results_snr*.json into --outputs, so a manifest inside
    # that directory (a previous run of this harness) would otherwise be
    # overwritten by this run's statistics and pass against itself.
    ref = _manifest_stats(args.manifest) if args.manifest else None

    cfg = train_config_from_args(args, "parity")
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, snr_idx=args.snr_idx))
    exp_dir, _, _ = experiment_dirs(cfg, "parity")
    outputs = args.outputs or os.path.join(exp_dir, "outputs")
    os.makedirs(outputs, exist_ok=True)

    from sos_tpu_torch.data import NoiseBank
    from sos_tpu_torch.infer.denoise import DenoiserPredictor
    from sos_tpu_torch.infer.detect import DetectorPredictor
    from sos_tpu_torch.infer.evaluate import (create_data_from_prediction,
                                              evaluate_denoiser,
                                              evaluate_detector)
    from sos_tpu_torch.models.torch_import import (
        import_denoiser_checkpoint, import_detector_checkpoint)

    det_state = import_detector_checkpoint(args.detector_pth)
    den_state = import_denoiser_checkpoint(args.denoiser_pth)
    snr = cfg.data.snrs[args.snr_idx]

    # stage 1: full-utterance detection over mixed inputs (known clean)
    noise = NoiseBank.from_roots(args.noise_root, cfg.data.sample_rate)
    detector = DetectorPredictor(cfg, det_state, threshold=args.threshold,
                                 device=args.device)
    eval_json = evaluate_detector(
        cfg, detector, args.dataset_json, outputs, noise_bank=noise,
        snr_idx=args.snr_idx, clean_audio=True)
    # bridge: re-mix with the saved noise assignment, write recovered/
    pred_data = create_data_from_prediction(
        cfg, eval_json, noise_snr=snr, clean_audio=True)
    # stage 2: denoise + 16 kHz metric suite
    denoiser = DenoiserPredictor(cfg, den_state, device=args.device)
    final_json = evaluate_denoiser(
        cfg, denoiser, pred_data, outputs, snr=snr,
        unknown_clean_signal=False, save_individual_results=False)

    with open(final_json) as fp:
        ours = {k: float(v)
                for k, v in json.load(fp)["denoise_statistics"].items()}
    print(f"this run ({os.path.basename(final_json)}):")
    for k, v in ours.items():
        print(f"  {k:<18} {v: .4f}")

    if ref is None:
        print("\nno --manifest given: statistics printed only. Diff a "
              "reference run by passing its eval_results JSON.")
        return

    report = {"snr": snr, "tolerance": args.tolerance, "ours": ours,
              "reference": ref, "delta": {}}
    print(f"\ndelta vs {args.manifest} (ours - reference):")
    for k in ref:
        if k in ours:
            report["delta"][k] = ours[k] - ref[k]
            print(f"  {k:<18} {report['delta'][k]:+.4f}")
    gated = ("avg_pesq", "avg_stoi")
    missing = [k for k in gated if k not in report["delta"]]
    if missing:
        # a manifest without the gated metrics must not pass vacuously
        print(f"PARITY ERROR: {', '.join(missing)} absent from the "
              "manifest-vs-run comparison; cannot evaluate the parity bar",
              file=sys.stderr)
        sys.exit(2)
    failures = [k for k in gated
                if abs(report["delta"][k]) > args.tolerance]
    report["pass"] = not failures
    if args.out:
        with open(args.out, "w") as fp:
            json.dump(report, fp, indent=2)
        print(f"wrote {args.out}")
    if failures:
        print(f"PARITY FAIL: {', '.join(failures)} exceed "
              f"|delta| <= {args.tolerance}", file=sys.stderr)
        sys.exit(1)
    print(f"PARITY OK: avg_pesq/avg_stoi within +-{args.tolerance}")


if __name__ == "__main__":
    main()
