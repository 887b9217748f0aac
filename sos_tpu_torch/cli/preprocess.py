"""Build a dataset JSON from a directory of WAVs.

Usage:
    python -m sos_tpu_torch preprocess --audio_dir data/my_clips \
        --output_json data/my_clips.json [--label_silence]

The port's copy of `sos_tpu/cli/preprocess.py`, with its flags and its
JSON; host work (decode, resample, energy labels), no device.

Equivalent of `preprocessing/preprocessor_audioonly.py` run as a script
(README.md:57-63), without ffmpeg: native WAV decode + polyphase resample.
`--label_silence` applies the energy-threshold ground-truth labeler
(preprocessing/util.py:600-778) instead of all-'1' bitstreams.
"""

import argparse

from sos_tpu_torch.data.preprocess import build_dataset_json


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--audio_dir", type=str, required=True)
    parser.add_argument("--output_json", type=str, required=True)
    parser.add_argument("--label_silence", action="store_true",
                        help="energy-threshold silence labeling (else all-'1')")
    parser.add_argument("--label_threshold", type=float, default=0.08,
                        help="normalized per-frame energy below this is "
                             "silence (reference algorithm's 0.08, "
                             "preprocessing/util.py:600-778)")
    parser.add_argument("--label_pad_seconds", type=float, default=0.0,
                        help="mark the first/last N seconds of frames '2' "
                             "(ignore-padding; the released data used 15 "
                             "for YouTube-clip margins — 0 suits "
                             "standalone WAVs)")
    args = parser.parse_args()
    index = build_dataset_json(args.audio_dir, args.output_json,
                               label_silence=args.label_silence,
                               label_threshold=args.label_threshold,
                               label_pad_seconds=args.label_pad_seconds)
    print(f"wrote {args.output_json}: {index.num_files} files")


if __name__ == "__main__":
    main()
