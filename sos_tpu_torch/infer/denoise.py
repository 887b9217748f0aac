"""Stage-2 inference: full-utterance denoising from predicted silent
intervals (port of `sos_tpu/infer/denoise.py`).

waveform -> STFT [K1] -> JointDenoiser [K4] -> cRM recover + iSTFT [K3]
on the device; the bitstream -> sample mask (`bitstream_to_sample_mask_np`,
an O(L) difference array, so no length limit) and the WAV codec stay on
the host, as in `sos_tpu`. The predicted full noise and the gated noise
observation go through the plain iSTFT (a matmul outside any kernel in
`sos_tpu` too).

Modes, as in `sos_tpu`: exact (`buckets=None`, each utterance at its
length) and, with `buckets` (spectrogram-frame counts), the bucketed one
that serves every shorter utterance of a bucket with the same result:
host reflect padding + zero extension, the STFT without centering [K1
`center=False`], the model's valid-aware path (per-row reflection at the
valid boundary, tail re-zeroing, BiLSTM with per-row lengths [K4]) and
the iSTFT normalized by each row's valid frames [K3 per-row `valid_t`].
`denoise_batch` runs same-bucket utterances in tiles of `batch_size`
rows. The int8 profile runs the exact mode only (ROADMAP.md queue 1
item 3).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from sos_tpu_torch.config import ExperimentConfig
from sos_tpu_torch.dsp.mixing import bitstream_to_sample_mask_np
from sos_tpu_torch.dsp.stft import crm_istft, istft_packed, stft, stft_cat
from sos_tpu_torch.infer.detect import (INT8_BUCKETS_MESSAGE, bucket_buffer,
                                        to_device)
from sos_tpu_torch.infer.fused import _nchw
from sos_tpu_torch.models import JointDenoiser
from sos_tpu_torch.models.layers import exact_fp32, resolve_device
from sos_tpu_torch.models.quant import (QuantizedDenoiser,
                                        load_persisted_calibration)

KEYS = ("denoised", "predicted_noise", "gated_noise")


class DenoiserPredictor:
    def __init__(self, cfg: ExperimentConfig, state: Dict,
                 buckets: Optional[Sequence[int]] = None,
                 profile: Optional[str] = None,
                 calibration_path: Optional[str] = None, device="cuda"):
        """`state`: the JointDenoiser's state_dict. `profile`: None/"f32"
        (reference-exact), "bf16" (bf16 conv trunks) or "int8" (quantized
        trunks, exact mode only). `calibration_path`: the int8
        activation-scale JSON, loaded when present, else the predictor
        calibrates on its first utterance. `device`: "cuda" (default) or
        "cpu"."""
        profile = profile or "f32"
        if profile not in ("f32", "bf16", "int8"):
            raise ValueError(f"profile must be f32|bf16|int8, got {profile!r}")
        self.buckets = tuple(buckets) if buckets else None
        if profile == "int8" and self.buckets is not None:
            raise NotImplementedError(INT8_BUCKETS_MESSAGE)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.profile = profile
        self._calibration_path = calibration_path
        self._quant = self.model = None
        if profile == "int8":
            self._quant = QuantizedDenoiser(cfg.denoiser, state,
                                            device=self.device)
        else:
            dtype = "bfloat16" if profile == "bf16" else "float32"
            self.model = JointDenoiser(cfg.denoiser, dtype)
            self.model.load_state_dict(state)
            self.model.to(self.device).eval()

    def _mask(self, mixed: np.ndarray, bits: str, framerate: float) -> np.ndarray:
        return bitstream_to_sample_mask_np(
            np.asarray([0 if c == "0" else 1 for c in bits], np.float32),
            float(self.cfg.data.sample_rate) / framerate, len(mixed),
            self.cfg.data.despeckle_min_run)

    def _maybe_calibrate(self, mixed: np.ndarray, mask: np.ndarray) -> None:
        if self._quant is None or self._quant._calibrated:
            return
        if self._calibration_path and load_persisted_calibration(
                self._quant, self._calibration_path, "denoiser"):
            return
        scfg = self.cfg.stft
        geom = (scfg.n_fft, scfg.hop_length, scfg.win_length)
        with torch.no_grad(), exact_fp32():
            spec = stft(to_device(mixed[None], self.device), *geom)
            gated = stft(to_device((mixed * mask)[None], self.device), *geom)
        self._quant.calibrate([(spec, gated)])

    @torch.no_grad()
    def _run(self, mixed: torch.Tensor, gated: torch.Tensor,
             keys: Tuple[str, ...], valid_t=None) -> Dict[str, torch.Tensor]:
        """(B, n) mixed and gated waveforms on the device (pre-padded
        buffers when `valid_t` is given) -> the `keys` waveforms
        (B, (T-1)*hop), left on the device."""
        scfg = self.cfg.stft
        geom = (scfg.n_fft, scfg.hop_length, scfg.win_length)
        center = valid_t is None
        with exact_fp32():
            mixed_cat = stft_cat(mixed, *geom, center=center)
            gated_cat = stft_cat(gated, *geom, center=center)
            if self._quant is not None:
                noise, crm_cat = self._quant.forward_cat(mixed_cat, gated_cat)
            else:
                noise, crm_cat = self.model.forward_packed(
                    _nchw(mixed_cat), _nchw(gated_cat), valid_t)
            out = {}
            if "denoised" in keys:
                out["denoised"] = crm_istft(crm_cat, mixed_cat, *geom,
                                            valid_t=valid_t)
            if "predicted_noise" in keys:
                out["predicted_noise"] = istft_packed(
                    noise[:, 0].transpose(1, 2), noise[:, 1].transpose(1, 2),
                    *geom, valid_t=valid_t)
            if "gated_noise" in keys:
                bins = gated_cat.shape[-1] // 2
                out["gated_noise"] = istft_packed(
                    gated_cat[..., :bins], gated_cat[..., bins:], *geom,
                    valid_t=valid_t)
            return out

    def _bucket_t(self, valid_t: int) -> int:
        for b in self.buckets:
            if valid_t <= b:
                return b
        return valid_t

    def _need(self, bucket_t: int) -> int:
        return (bucket_t - 1) * self.cfg.stft.hop_length + self.cfg.stft.n_fft

    def denoise_waveform(self, mixed: np.ndarray, bits: str,
                         framerate: float = 30.0) -> Dict[str, np.ndarray]:
        """Denoise one utterance given its (predicted) silence bitstream.

        Returns the denoised waveform, the predicted full noise and the
        gated noise observation, all of the iSTFT's length (T-1)*hop, like
        the reference's outputs (m2 predict.py:422-426)."""
        hop = self.cfg.stft.hop_length
        mask = self._mask(mixed, bits, framerate)
        out_len = (1 + len(mixed) // hop - 1) * hop
        mixed = mixed.astype(np.float32)
        self._maybe_calibrate(mixed, mask)
        if self.buckets is None:
            m = to_device(mixed[None], self.device)
            outs = self._run(m, m * to_device(mask[None], self.device), KEYS)
        else:
            valid_t = 1 + len(mixed) // hop
            need = self._need(self._bucket_t(valid_t))
            n_fft = self.cfg.stft.n_fft
            outs = self._run(
                to_device(bucket_buffer(mixed, n_fft, need)[None], self.device),
                to_device(bucket_buffer(mixed * mask, n_fft, need)[None],
                          self.device),
                KEYS, to_device(np.asarray([valid_t]), self.device))
        return {k: v[0].cpu().numpy()[:out_len] for k, v in outs.items()}

    def denoise_batch(self, mixed_list: Sequence[np.ndarray],
                      bits_list: Sequence[str], framerate: float = 30.0,
                      batch_size: int = 8,
                      keys: Tuple[str, ...] = KEYS) -> list:
        """Batched full-utterance denoising: same-bucket utterances share
        one call per tile, each row equal to `denoise_waveform`'s. Without
        `buckets`, the per-item path. `keys` selects the waveforms brought
        back (eval needs "denoised" only unless it saves the others).
        Returns a list of dicts in input order."""
        keys = tuple(keys)
        if self.buckets is None:
            return [self.denoise_waveform(m, b, framerate)
                    for m, b in zip(mixed_list, bits_list)]
        hop, n_fft = self.cfg.stft.hop_length, self.cfg.stft.n_fft
        groups: Dict[int, list] = {}
        for i, m in enumerate(mixed_list):
            groups.setdefault(self._bucket_t(1 + len(m) // hop), []).append(i)

        results: list = [None] * len(mixed_list)
        pending = []  # every tile dispatched, then fetched
        for bucket_t, idxs in groups.items():
            need = self._need(bucket_t)
            for s in range(0, len(idxs), batch_size):
                tile = idxs[s: s + batch_size]
                mixed_buf = np.zeros((batch_size, need), np.float32)
                gated_buf = np.zeros((batch_size, need), np.float32)
                vts = np.zeros(batch_size, np.int64)
                for row, i in enumerate(tile):
                    m = np.asarray(mixed_list[i], np.float32)
                    mask = self._mask(m, bits_list[i], framerate)
                    mixed_buf[row] = bucket_buffer(m, n_fft, need)
                    gated_buf[row] = bucket_buffer(m * mask, n_fft, need)
                    vts[row] = 1 + len(m) // hop
                last = len(tile) - 1
                mixed_buf[last + 1:], gated_buf[last + 1:], vts[last + 1:] = \
                    mixed_buf[last], gated_buf[last], vts[last]  # repeat
                outs = self._run(to_device(mixed_buf, self.device),
                                 to_device(gated_buf, self.device), keys,
                                 to_device(vts, self.device))
                pending.append((tile, vts, outs))
        for tile, vts, outs in pending:
            host = {k: v.cpu().numpy() for k, v in outs.items()}
            for row, i in enumerate(tile):
                out_len = (vts[row] - 1) * hop
                results[i] = {k: host[k][row][:out_len] for k in keys}
        return results
