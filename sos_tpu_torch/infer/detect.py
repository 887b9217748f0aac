"""Stage-1 inference: full-utterance silent-interval detection
(port of `sos_tpu/infer/detect.py`).

The full-length mixed spectrogram goes through the conv + BiLSTM
detector with `num_frames = len(file bitstream)`; sigmoid confidences
are thresholded at 0.5 into predicted bits (m1 predict.py:106-149).

Three modes, as in `sos_tpu`:

* exact (`buckets=None`): each utterance at its own length: centered
  STFT [K1], the static model [K4];
* bucketed (`predict_waveform` with `buckets`): the frame count rounds up
  to a bucket; the host applies the centered STFT's reflect padding and
  zero-extends to the bucket's samples, the card takes the STFT without
  centering [K1 `center=False`] and runs the model's valid-aware path
  (frames >= valid_t re-zeroed after every conv, the frame grid
  resampled from the valid region, BiLSTM steps >= the stream's frames
  treated as padding [K4 per-row lengths]), so the result equals the
  exact mode's;
* batched-bucketed (`predict_batch`): utterances grouped by (bucket,
  frame bucket) share one call per tile of `batch_size` rows, each row
  with its own valid lengths; short tiles repeat their last row. Every
  tile is dispatched before any is fetched.

torch compiles nothing, so `sos_tpu`'s per-program cache has no
counterpart. The int8 profile runs the exact mode only: its bucketed
path needs K6 with the time mask, the next slice's work (ROADMAP.md
queue 1 item 3).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from sos_tpu_torch.config import ExperimentConfig
from sos_tpu_torch.dsp.stft import stft, stft_cat
from sos_tpu_torch.infer.fused import _nchw
from sos_tpu_torch.models import SilenceDetector
from sos_tpu_torch.models.layers import exact_fp32, resolve_device
from sos_tpu_torch.models.quant import (QuantizedDetector,
                                        load_persisted_calibration)

FRAMES_GRANULARITY = 64  # the video-frame grid rounds up to multiples of this

INT8_BUCKETS_MESSAGE = (
    "the int8 profile runs the exact mode only (buckets=None): its "
    "length-bucketed path (K6 with the time mask, K7 with the time tails, "
    "rows over 192) is the next slice, ROADMAP.md queue 1 item 3")


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device`: through pinned memory without waiting
    for the stream when `device` is a card (a pageable copy would)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def bucket_buffer(signal: np.ndarray, n_fft: int, need: int) -> np.ndarray:
    """The centered STFT's reflect padding applied on the host, then
    zero-extended (or cut) to `need` samples."""
    reflected = np.pad(np.asarray(signal, np.float32), n_fft // 2,
                       mode="reflect")
    out = np.zeros(need, np.float32)
    out[:min(len(reflected), need)] = reflected[:need]
    return out


class DetectorPredictor:
    def __init__(self, cfg: ExperimentConfig, state: Dict,
                 threshold: float = 0.5,
                 buckets: Optional[Sequence[int]] = None,
                 profile: Optional[str] = None,
                 calibration_path: Optional[str] = None, device="cuda"):
        """`state`: the detector's state_dict (`models/convert.py` or
        `models/torch_import.py` make it). `profile`: None/"f32", "bf16"
        (bf16 conv trunk) or "int8" (quantized trunk, exact mode only).
        `calibration_path` loads persisted int8 scales (the schema
        `FusedDenoisePipeline` writes); else the predictor calibrates on
        its first utterance. `device`: "cuda" (default) or "cpu"."""
        profile = profile or "f32"
        if profile not in ("f32", "bf16", "int8"):
            raise ValueError(f"profile must be f32|bf16|int8, got {profile!r}")
        self.buckets = tuple(sorted(buckets)) if buckets else None
        if profile == "int8" and self.buckets is not None:
            raise NotImplementedError(INT8_BUCKETS_MESSAGE)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.threshold = threshold
        self.profile = profile
        self._calibration_path = calibration_path
        self._quant = self.model = None
        if profile == "int8":
            self._quant = QuantizedDetector(cfg.detector, state,
                                            device=self.device)
        else:
            dtype = "bfloat16" if profile == "bf16" else "float32"
            self.model = SilenceDetector(cfg.detector, dtype)
            self.model.load_state_dict(state)
            self.model.to(self.device).eval()

    def _maybe_calibrate(self, waveform: np.ndarray) -> None:
        if self._quant is None or self._quant._calibrated:
            return
        if self._calibration_path and load_persisted_calibration(
                self._quant, self._calibration_path, "detector"):
            return
        scfg = self.cfg.stft
        x = to_device(np.asarray(waveform, np.float32)[None], self.device)
        with torch.no_grad(), exact_fp32():
            spec = stft(x, scfg.n_fft, scfg.hop_length, scfg.win_length)
        self._quant.calibrate([spec])

    def _conf(self, spec_cat: torch.Tensor, num_frames: int, valid_t=None,
              valid_frames=None) -> torch.Tensor:
        if self._quant is not None:
            logits = self._quant.logits_cat(spec_cat, num_frames)
        else:
            logits = self.model.forward_nchw(_nchw(spec_cat), num_frames,
                                             valid_t, valid_frames)
        return torch.sigmoid(logits)

    def _bucket_t(self, valid_t: int) -> int:
        for b in self.buckets:
            if valid_t <= b:
                return b
        return valid_t

    def _frames_bucket(self, num_frames: int) -> int:
        return -(-num_frames // FRAMES_GRANULARITY) * FRAMES_GRANULARITY

    def _need(self, bucket_t: int) -> int:
        return (bucket_t - 1) * self.cfg.stft.hop_length + self.cfg.stft.n_fft

    @torch.no_grad()
    def _run_bucketed(self, buf: np.ndarray, vts: np.ndarray,
                      vfs: np.ndarray, frames_bucket: int) -> torch.Tensor:
        """(rows, need) buffers with their valid frame counts -> the
        confidences (rows, frames_bucket), left on the device."""
        scfg = self.cfg.stft
        x = to_device(buf, self.device)
        valid_t = to_device(vts.astype(np.int64), self.device)
        valid_frames = to_device(vfs.astype(np.int64), self.device)
        with exact_fp32():
            spec = stft_cat(x, scfg.n_fft, scfg.hop_length, scfg.win_length,
                            center=False)
            return self._conf(spec, frames_bucket, valid_t, valid_frames)

    def predict_waveform(self, waveform: np.ndarray,
                         num_frames: int) -> Tuple[np.ndarray, np.ndarray]:
        """(mixed waveform @14kHz, #video frames) -> (bits, confidences)."""
        scfg = self.cfg.stft
        self._maybe_calibrate(waveform)
        if self.buckets is None:
            x = to_device(np.asarray(waveform, np.float32)[None], self.device)
            with torch.no_grad(), exact_fp32():
                spec = stft_cat(x, scfg.n_fft, scfg.hop_length,
                                scfg.win_length)
                conf = self._conf(spec, num_frames)[0].cpu().numpy()
        else:
            valid_t = 1 + len(waveform) // scfg.hop_length
            bucket_t = self._bucket_t(valid_t)
            frames_bucket = self._frames_bucket(num_frames)
            buf = bucket_buffer(waveform, scfg.n_fft, self._need(bucket_t))
            conf = self._run_bucketed(
                buf[None], np.asarray([valid_t]), np.asarray([num_frames]),
                frames_bucket)[0].cpu().numpy()[:num_frames]
        bits = (conf >= self.threshold).astype(np.int64)
        return bits, conf

    def predict_batch(self, waveforms: Sequence[np.ndarray],
                      num_frames: Sequence[int],
                      batch_size: int = 16) -> list:
        """Batched full-utterance detection: same-bucket utterances share
        one call per tile, each row's result equal to `predict_waveform`'s.
        Without `buckets`, the per-item exact path. Returns a list of
        (bits, confidences) in input order."""
        if self.buckets is None:
            return [self.predict_waveform(w, n)
                    for w, n in zip(waveforms, num_frames)]
        if waveforms:
            self._maybe_calibrate(np.asarray(waveforms[0], np.float32))
        hop, n_fft = self.cfg.stft.hop_length, self.cfg.stft.n_fft
        groups: Dict[Tuple[int, int], list] = {}
        for i, (w, nf) in enumerate(zip(waveforms, num_frames)):
            key = (self._bucket_t(1 + len(w) // hop), self._frames_bucket(nf))
            groups.setdefault(key, []).append(i)

        results: list = [None] * len(waveforms)
        pending = []  # every tile dispatched, then fetched
        for (bucket_t, frames_bucket), idxs in groups.items():
            need = self._need(bucket_t)
            for s in range(0, len(idxs), batch_size):
                tile = idxs[s: s + batch_size]
                buf = np.zeros((batch_size, need), np.float32)
                vts = np.zeros(batch_size, np.int64)
                vfs = np.zeros(batch_size, np.int64)
                for row, i in enumerate(tile):
                    buf[row] = bucket_buffer(waveforms[i], n_fft, need)
                    vts[row] = 1 + len(waveforms[i]) // hop
                    vfs[row] = num_frames[i]
                last = len(tile) - 1
                buf[last + 1:], vts[last + 1:], vfs[last + 1:] = \
                    buf[last], vts[last], vfs[last]  # repeat the last row
                pending.append((tile, self._run_bucketed(
                    buf, vts, vfs, frames_bucket)))
        for tile, conf_dev in pending:
            conf_all = conf_dev.cpu().numpy()
            for row, i in enumerate(tile):
                conf = conf_all[row, : num_frames[i]]
                results[i] = ((conf >= self.threshold).astype(np.int64), conf)
        return results
