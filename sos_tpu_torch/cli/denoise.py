"""One-shot denoising on the card: noisy WAV in -> clean WAV out
(port of `sos_tpu/cli/denoise.py`).

Usage:
    python -m sos_tpu_torch.cli.denoise --input noisy.wav --output clean.wav \\
        [--detector_ckpt latest --denoiser_ckpt latest | \\
         --detector_pth det.pth --denoiser_pth den.pth] \\
        [--chunk_seconds 2.0 --overlap_seconds 0.5] [--profile int8] \\
        [--device cpu]

    # batch mode: every wav under a directory, one model load, chunks of
    # all files batched into shared dispatches (denoise_many)
    python -m sos_tpu_torch.cli.denoise --input_dir noisy/ --output_dir clean/ ...

Runs the fused detect + denoise pipeline on audio of any length
(chunked streaming with crossfade overlap-add). Input is resampled to
the 14 kHz processing rate; output is written at the same rate.
"""

import argparse
import os

import numpy as np

from sos_tpu_torch.cli.common import (add_serving_args, config_from_args,
                                      default_calibration_path,
                                      experiment_dirs, load_checkpoint_states)
from sos_tpu_torch.dsp import audio_io
from sos_tpu_torch.infer.streaming import StreamingDenoiser

# batch mode holds at most ~this many full chunk batches of audio on the
# host at once (see the grouping loop in main)
GROUP_CHUNK_BATCHES = 4


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    add_serving_args(parser)
    parser.add_argument("--input", type=str, default=None)
    parser.add_argument("--output", type=str, default=None)
    parser.add_argument("--input_dir", type=str, default=None,
                        help="denoise every .wav under this directory "
                             "(non-recursive) instead of --input; chunks "
                             "of all files share dispatches")
    parser.add_argument("--output_dir", type=str, default=None,
                        help="where batch-mode outputs go (same "
                             "basenames); required with --input_dir")
    parser.add_argument("--chunk_seconds", type=float, default=2.0)
    parser.add_argument("--overlap_seconds", type=float, default=0.5)
    parser.add_argument("--detector_context_seconds", type=float,
                        default=None,
                        help="total detector window per chunk "
                             "(two-pass mode): > chunk_seconds "
                             "prepends left context for low-SNR "
                             "detection without changing chunk "
                             "latency (e.g. 6.0 below ~-5 dB SNR)")
    parser.add_argument("--threshold", type=float, default=0.5)
    parser.add_argument("--bf16", action="store_true",
                        help="shorthand for --profile bf16")
    parser.add_argument("--profile", type=str, default=None,
                        choices=("f32", "bf16", "int8"),
                        help="f32 = reference-exact, bf16 = bf16 conv "
                             "trunks, int8 = int8 trunks and InpaintNet "
                             "(self-calibrates on the first batch)")
    parser.add_argument("--transfer_dtype", type=str, default="float32",
                        choices=("float32", "int16"),
                        help="wire dtype for host<->device waveforms; "
                             "int16 halves transfer bytes (lossless for "
                             "16-bit PCM inputs, output within 1/65536)")
    parser.add_argument("--calibration_json", type=str, default=None,
                        help="int8 activation-scale file; loaded when "
                             "present, else written after the first "
                             "self-calibration (default: "
                             "<denoiser model dir>/int8_calibration.json)")
    parser.add_argument("--exact_f32_head", action="store_true",
                        help="int8 profile: run the LSTM input projection "
                             "in exact f32 instead of the default bf16")
    args = parser.parse_args()
    batch_mode = args.input_dir is not None
    if batch_mode:
        if args.output_dir is None:
            parser.error("--input_dir requires --output_dir")
        if args.input or args.output:
            parser.error("--input/--output and --input_dir/--output_dir "
                         "are mutually exclusive")
    elif not (args.input and args.output):
        parser.error("either --input + --output or --input_dir + "
                     "--output_dir is required")

    cfg = config_from_args(args)
    det_state, den_state = load_checkpoint_states(parser, args, cfg)
    _, _, den_dir = experiment_dirs(cfg, "denoiser")
    profile = args.profile or ("bf16" if args.bf16 else None)
    calib = default_calibration_path(den_dir, profile,
                                     args.calibration_json)
    stream = StreamingDenoiser(
        cfg, det_state, den_state, chunk_seconds=args.chunk_seconds,
        detector_context_seconds=args.detector_context_seconds,
        overlap_seconds=args.overlap_seconds, threshold=args.threshold,
        profile=profile, calibration_path=calib,
        transfer_dtype=args.transfer_dtype,
        bf16_head_proj=not args.exact_f32_head, device=args.device)
    sr = cfg.data.sample_rate

    if not batch_mode:
        wav, _ = audio_io.load(args.input, sr=sr)
        out = stream.denoise(wav.astype(np.float32))
        audio_io.write_wav(args.output, out, sr)
        print(f"denoised {len(wav) / sr:.1f}s -> {args.output}")
        return

    names = sorted(n for n in os.listdir(args.input_dir)
                   if n.lower().endswith(".wav"))
    if not names:
        raise SystemExit(f"no .wav files in {args.input_dir}")
    os.makedirs(args.output_dir, exist_ok=True)
    # Groups keep host memory bounded on huge directories while each
    # dispatch batch still fills: a group closes once it holds about
    # GROUP_CHUNK_BATCHES full chunk batches, counted in chunks (a file
    # shorter than a chunk still takes a whole zero-padded chunk).
    # denoise_many is per-utterance independent, so grouping changes an
    # output only by float rounding: a single-chunk file takes the fused
    # call when its group holds only single-chunk files, the two-pass
    # route otherwise.
    budget = GROUP_CHUNK_BATCHES * stream.batch_chunks
    group, group_names, held = [], [], 0
    n_files, total = 0, 0.0

    def flush():
        nonlocal group, group_names, held, n_files, total
        if not group:
            return
        for name, wav, out in zip(group_names, group,
                                  stream.denoise_many(group)):
            dst = os.path.join(args.output_dir, name)
            audio_io.write_wav(dst, out, sr)
            print(f"denoised {len(wav) / sr:.1f}s -> {dst}")
            n_files += 1
            total += len(wav) / sr
        group, group_names, held = [], [], 0

    for name in names:
        wav = audio_io.load(os.path.join(args.input_dir, name),
                            sr=sr)[0].astype(np.float32)
        group.append(wav)
        group_names.append(name)
        # chunk count mirrors StreamingDenoiser.denoise_many's layout
        held += (1 if len(wav) <= stream.chunk
                 else -(-len(wav) // stream.stride))
        if held >= budget:
            flush()
    flush()
    print(f"batch: {n_files} files, {total:.1f}s audio")


if __name__ == "__main__":
    main()
