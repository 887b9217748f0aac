"""Stage-1 inference: detect silent intervals over a dataset JSON
(port of `sos_tpu/cli/predict_detector.py`).

Usage:
    python -m sos_tpu_torch.cli.predict_detector --dataset_json data/sos.json \
        [--ckpt latest | --pth ckpt_epoch87.pth] [--snr_idx 3] [--buckets 256 512 1024] \
        [--eval_batch_size 8] [--unknown_clean_signal true] \
        --noise_root data/noise_data_DEMAND/test_noise [--device cpu]

Equivalent of model_1 `predict.py` (m1 predict.py:38-233,415-460): writes
`eval_results{_snrX}.json` + the per-file noise assignment under
`noise{_snrX}/`. `--unknown_clean_signal true` skips mixing (the input
wavs are already noisy; m1 predict.py:43-46). Runs on the CUDA card
unless given `--device cpu`.
"""

import argparse
import dataclasses
import os

from sos_tpu_torch.cli.common import (add_eval_args, config_from_args,
                                      default_calibration_path,
                                      experiment_dirs, load_stage_state)
from sos_tpu_torch.data import NoiseBank
from sos_tpu_torch.infer.detect import DetectorPredictor
from sos_tpu_torch.infer.evaluate import evaluate_detector


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    add_eval_args(parser)
    parser.add_argument("--snr_idx", type=int, default=None)
    parser.add_argument("--threshold", type=float, default=0.5)
    parser.add_argument("--buckets", type=int, nargs="*", default=None,
                        help="length buckets (spectrogram frames): one "
                             "shape per bucket; numerically exact")
    parser.add_argument(
        "--unknown_clean_signal",
        type=lambda x: str(x).lower() in ("true", "1", "yes"), default=False)
    parser.add_argument("--outputs", type=str, default=None)
    parser.add_argument("--eval_batch_size", type=int, default=None,
                        help="batch same-bucket utterances per device "
                             "call (needs --buckets)")
    parser.add_argument("--save_individual", action="store_true",
                        help="save wav + bitstream/confidence overlay plots "
                             "for mismatched or silent items "
                             "(m1 predict.py:150-183)")
    parser.add_argument("--profile", type=str, default=None,
                        choices=("f32", "bf16", "int8"),
                        help="f32 (default), bf16, or int8 (every mode, "
                             "--buckets included)")
    parser.add_argument("--calibration_json", type=str, default=None,
                        help="persisted int8 activation scales (defaults "
                             "to the denoiser model dir's file)")
    args = parser.parse_args()
    cfg = config_from_args(args)
    exp_dir, _, _ = experiment_dirs(cfg, "detector")
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, snr_idx=args.snr_idx))

    outputs = args.outputs or os.path.join(exp_dir, "outputs", os.path.basename(
        args.dataset_json).split(".json")[0])
    state = load_stage_state(parser, cfg, "detector", args.ckpt,
                             args.pth)
    _, _, den_model_dir = experiment_dirs(cfg, "denoiser", make=False)
    calib = default_calibration_path(den_model_dir, args.profile,
                                     args.calibration_json)
    predictor = DetectorPredictor(cfg, state, threshold=args.threshold,
                                  buckets=args.buckets or None,
                                  profile=args.profile,
                                  calibration_path=calib, device=args.device)

    clean_audio = not args.unknown_clean_signal
    noise = NoiseBank.from_roots(args.noise_root, cfg.data.sample_rate) \
        if clean_audio else None
    out = evaluate_detector(cfg, predictor, args.dataset_json, outputs,
                            noise_bank=noise, snr_idx=args.snr_idx,
                            clean_audio=clean_audio,
                            save_individual_results=args.save_individual,
                            batch_size=args.eval_batch_size)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
