"""Stage-2 inference: denoise from a pred_data.json handshake file
(port of `sos_tpu/cli/predict_denoiser.py`).

Usage:
    python -m sos_tpu_torch.cli.predict_denoiser --pred_data outputs/pred_data.json \
        [--ckpt latest | --pth ckpt_epoch24.pth] [--snr 0] [--buckets 256 512 1024] \
        [--eval_batch_size 8] [--unknown_clean_signal true] [--device cpu]

Equivalent of model_2 `predict.py` (m2 predict.py:255-626): per file
writes denoised_output.wav / predicted_full_noise.wav / noise_intervals.wav
/ noisy_input.wav + stat.json; aggregates the speech-metric suite into
`eval_results{_snrX}.json` when the clean signal is known. Runs on the
CUDA card unless given `--device cpu`.
"""

import argparse
import os

from sos_tpu_torch.cli.common import (add_eval_args, config_from_args,
                                      default_calibration_path,
                                      experiment_dirs, load_stage_state)
from sos_tpu_torch.infer.denoise import DenoiserPredictor
from sos_tpu_torch.infer.evaluate import evaluate_denoiser


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    add_eval_args(parser, need_dataset=False)
    parser.add_argument("--pred_data", type=str, required=True,
                        help="stage-1 bridge output JSON")
    parser.add_argument("--snr", type=float, default=None)
    parser.add_argument("--buckets", type=int, nargs="*", default=None,
                        help="length buckets (spectrogram frames): one "
                             "shape per bucket; numerically exact")
    parser.add_argument(
        "--unknown_clean_signal",
        type=lambda x: str(x).lower() in ("true", "1", "yes"), default=False)
    parser.add_argument(
        "--save_results",
        type=lambda x: str(x).lower() in ("true", "1", "yes"), default=True)
    parser.add_argument("--eval_batch_size", type=int, default=None,
                        help="batch same-bucket utterances per device "
                             "call (needs --buckets)")
    parser.add_argument("--outputs", type=str, default=None)
    parser.add_argument("--profile", type=str, default=None,
                        choices=("f32", "bf16", "int8"),
                        help="f32 (default), bf16, or int8 (every mode, "
                             "--buckets included)")
    parser.add_argument("--calibration_json", type=str, default=None,
                        help="persisted int8 activation scales (defaults "
                             "to the denoiser model dir's file)")
    args = parser.parse_args()
    if not args.unknown_clean_signal and args.snr is None:
        parser.error("--unknown_clean_signal false REQUIRES --snr")
    cfg = config_from_args(args)
    exp_dir, _, model_dir = experiment_dirs(cfg, "denoiser")
    outputs = args.outputs or os.path.join(exp_dir, "outputs")

    state = load_stage_state(parser, cfg, "denoiser", args.ckpt,
                             args.pth)
    calib = default_calibration_path(model_dir, args.profile,
                                     args.calibration_json)
    predictor = DenoiserPredictor(cfg, state, buckets=args.buckets or None,
                                  profile=args.profile,
                                  calibration_path=calib, device=args.device)
    out = evaluate_denoiser(cfg, predictor, args.pred_data, outputs,
                            snr=args.snr,
                            unknown_clean_signal=args.unknown_clean_signal,
                            save_individual_results=args.save_results,
                            batch_size=args.eval_batch_size)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
