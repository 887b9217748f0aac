"""Export the fused denoise pipeline as a standalone serving artifact.

Usage:
    python -m sos_tpu_torch export_serving --output denoise_b128.pt \
        --batch 128 [--profile int8 [--calibration_json scales.json]] \
        [--clip_seconds 2.0] [--platforms cuda cpu] \
        --output_root model_output --name exp \
        [--detector_ckpt latest --denoiser_ckpt latest | --*_pth ...]

(Port of `sos_tpu/cli/export_serving.py`, the same flags.) Writes
`<output>` (a `torch.save` file: the config, both models' weights, the
int8 scales, the metadata; read back with `torch.load(weights_only=True)`)
plus `<output>.json` (shape/profile metadata). Load with
`sos_tpu_torch.infer.export.load_denoise_program`, which needs the
`sos_tpu_torch` package (its kernels) but no checkpoint. Export one
artifact per serving bucket (batch, clip length). `--platforms` takes
`cuda` and `cpu`; a TPU artifact is the JAX package's.
"""

import argparse
import os

from sos_tpu_torch.cli.common import (add_common_train_args,
                                      default_calibration_path,
                                      experiment_dirs,
                                      load_checkpoint_states,
                                      train_config_from_args)
from sos_tpu_torch.infer.export import (PLATFORMS, check_platforms,
                                        export_denoise_program)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_train_args(parser, need_dataset=False)
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--clip_seconds", type=float, default=2.0)
    parser.add_argument("--threshold", type=float, default=0.5)
    parser.add_argument("--profile", type=str, default="f32",
                        choices=("f32", "bf16", "int8"))
    parser.add_argument("--calibration_json", type=str, default=None,
                        help="int8 activation scales (required for int8; "
                             "default: <denoiser model dir>/"
                             "int8_calibration.json)")
    parser.add_argument("--platforms", type=str, nargs="+",
                        default=list(PLATFORMS),
                        help="devices the artifact may be loaded on: "
                             "cuda and/or cpu")
    parser.add_argument("--transfer_dtype", type=str, default="float32",
                        choices=("float32", "int16"),
                        help="int16: the artifact takes/returns int16 "
                             "PCM wire samples (fused.wire_encode/"
                             "wire_decode convert)")
    parser.add_argument("--detector_ckpt", type=str, default="latest")
    parser.add_argument("--denoiser_ckpt", type=str, default="latest")
    parser.add_argument("--detector_pth", type=str, default=None)
    parser.add_argument("--denoiser_pth", type=str, default=None)
    parser.add_argument("--exact_f32_head", action="store_true",
                        help="int8 profile: exact-f32 LSTM input "
                             "projection instead of the default bf16")
    args = parser.parse_args(argv)
    try:
        check_platforms(args.platforms)
    except ValueError as e:
        parser.error(str(e))

    cfg = train_config_from_args(args, "export")
    _, _, den_dir = experiment_dirs(cfg, "denoiser", make=False)
    det_state, den_state = load_checkpoint_states(parser, args, cfg)
    calib = default_calibration_path(den_dir, args.profile,
                                     args.calibration_json)
    path = export_denoise_program(
        cfg, det_state, den_state, args.output, batch=args.batch,
        clip_seconds=args.clip_seconds, threshold=args.threshold,
        profile=args.profile, calibration_path=calib,
        platforms=args.platforms, wire_dtype=args.transfer_dtype,
        bf16_head_proj=not args.exact_f32_head)
    size = os.path.getsize(path)
    print(f"exported {path} ({size / 1e6:.1f} MB, "
          f"platforms={args.platforms}, profile={args.profile}, "
          f"batch={args.batch})")


if __name__ == "__main__":
    main()
