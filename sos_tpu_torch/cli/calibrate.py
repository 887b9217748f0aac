"""Offline int8 calibration: derive activation scales from a corpus.

Usage:
    python -m sos_tpu_torch calibrate --input_dir noisy_wavs/ \
        --out scales.json [--max_clips 256] [--batch 16] \
        [--clip_seconds 2.0] [--threshold 0.5] [--device cuda|cpu] \
        --output_root model_output --name exp \
        [--detector_ckpt latest --denoiser_ckpt latest | --*_pth ...]

(Port of `sos_tpu/cli/calibrate.py`: the same flags, the same steps and
the same JSON schema, so one scale file serves both packages.) Without
a persisted scale file, the int8 serving pipeline self-calibrates on
whatever batch arrives first (infer/fused.py `_maybe_calibrate`, the
mixed spectrum standing in for the gated branch); this command derives
the scales from a representative corpus instead:

  1. chunk every wav into fixed clips at the processing rate,
  2. run the FLOAT detector on each batch -> bits -> despeckled sample
     mask and gate -> the true gated spectra (on the card: K1, the
     detector's BiLSTM on K4, K2; windows of any `--clip_seconds`),
  3. calibrate the quantized denoiser on (mixed, gated) pairs and the
     quantized detector on the mixed spectra,
  4. atomically write `--out` (default: the per-experiment
     int8_calibration.json the serve/denoise/export CLIs pick up).

Point --input_dir at audio matching the deployment's loudness and
noise profile; the scales are static maxima, so the corpus should
cover the loudest expected inputs.
"""

import argparse
import glob
import json
import os
import tempfile

import numpy as np

from sos_tpu_torch.cli.common import (add_common_train_args,
                                      experiment_dirs,
                                      load_checkpoint_states,
                                      train_config_from_args)


def chunk_corpus(paths, sample_rate: int, clip_samples: int,
                 max_clips: int) -> np.ndarray:
    """(N, clip_samples) float32 clips: every file cut into fixed clips,
    the tail zero-padded, at most `max_clips`."""
    from sos_tpu_torch.dsp import audio_io

    clips = []
    for path in paths:
        if len(clips) >= max_clips:
            break
        wav, _ = audio_io.load(path, sr=sample_rate)
        for start in range(0, max(len(wav), 1), clip_samples):
            seg = wav[start:start + clip_samples]
            if len(seg) < clip_samples:
                seg = np.pad(seg, (0, clip_samples - len(seg)))
            clips.append(seg.astype(np.float32))
            if len(clips) >= max_clips:
                break
    return np.stack(clips)


def calibration_pairs(cfg, detector, clips: np.ndarray, batch: int,
                      clip_seconds: float, threshold: float, device):
    """[(mixed, gated)] `(B, F, T, 2)` spectra on `device`, one pair a
    batch of `batch` clips (the tail padded to one shape): the float
    detector's bits gate each batch through K2."""
    import torch

    from sos_tpu_torch.dsp.mixing import mask_gate
    from sos_tpu_torch.dsp.stft import stft
    from sos_tpu_torch.models.layers import exact_fp32

    scfg = cfg.stft
    num_frames = int(clip_seconds * cfg.data.frame_rate)
    ratio = cfg.data.sample_rate / cfg.data.frame_rate
    pairs = []
    with torch.no_grad(), exact_fp32():
        for b in range(0, len(clips), batch):
            tile = clips[b:b + batch]
            if len(tile) < batch:
                tile = np.concatenate(
                    [tile, np.zeros((batch - len(tile), clips.shape[1]),
                                    np.float32)])
            mixed = torch.from_numpy(tile).to(device)
            mixed_stft = stft(mixed, scfg.n_fft, scfg.hop_length,
                              scfg.win_length)
            logits = detector(mixed_stft, num_frames)
            bits = (torch.sigmoid(logits) >= threshold).float()
            gated = mask_gate(mixed, bits, ratio, cfg.data.despeckle_min_run)
            pairs.append((mixed_stft, stft(gated, scfg.n_fft,
                                           scfg.hop_length, scfg.win_length)))
    return pairs


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_train_args(parser, need_dataset=False)
    parser.add_argument("--input_dir", type=str, required=True,
                        help="directory of representative noisy wavs")
    parser.add_argument("--glob", type=str, default="*.wav")
    parser.add_argument("--out", type=str, default=None,
                        help="scale-file path (default: <denoiser model "
                             "dir>/int8_calibration.json)")
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--max_clips", type=int, default=256,
                        help="cap on calibration clips (scales are "
                             "running maxima; more clips only help if "
                             "they add louder/denser material)")
    parser.add_argument("--clip_seconds", type=float, default=2.0)
    parser.add_argument("--threshold", type=float, default=0.5)
    parser.add_argument("--detector_ckpt", type=str, default="latest")
    parser.add_argument("--denoiser_ckpt", type=str, default="latest")
    parser.add_argument("--detector_pth", type=str, default=None)
    parser.add_argument("--denoiser_pth", type=str, default=None)
    args = parser.parse_args(argv)

    cfg = train_config_from_args(args, "calibrate")
    _, _, den_dir = experiment_dirs(cfg, "denoiser")
    paths = sorted(glob.glob(os.path.join(args.input_dir, args.glob)))
    if not paths:
        parser.error(f"no files match {args.input_dir}/{args.glob}")
    det_state, den_state = load_checkpoint_states(parser, args, cfg)

    from sos_tpu_torch.models import SilenceDetector
    from sos_tpu_torch.models.layers import resolve_device
    from sos_tpu_torch.models.quant import QuantizedDenoiser, QuantizedDetector

    device = resolve_device(args.device)
    clips = chunk_corpus(paths, cfg.data.sample_rate,
                         int(args.clip_seconds * cfg.data.sample_rate),
                         args.max_clips)
    detector = SilenceDetector(cfg.detector)
    detector.load_state_dict(det_state)
    detector.to(device).eval()
    pairs = calibration_pairs(cfg, detector, clips, args.batch,
                              args.clip_seconds, args.threshold, device)

    quant = QuantizedDenoiser(cfg.denoiser, den_state, device=device)
    quant.calibrate(pairs)
    quant_det = QuantizedDetector(cfg.detector, det_state, device=device)
    quant_det.calibrate([mixed for mixed, _ in pairs])

    state = {"denoiser": quant.calibration_state(),
             "detector": quant_det.calibration_state()}
    out = args.out or os.path.join(den_dir, "int8_calibration.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(out)),
                               suffix=".tmp")
    with os.fdopen(fd, "w") as fp:
        json.dump(state, fp, indent=1)
    os.replace(tmp, out)  # atomic: a reader never sees half a file
    print(f"calibrated on {len(clips)} clips ({len(paths)} files) -> {out}")


if __name__ == "__main__":
    main()
