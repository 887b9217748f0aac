"""Batched synthetic-mixture quality evaluation (port of
`sos_tpu/infer/synthetic_eval.py`, BASELINE config[1]).

Mixes clean test clips with corpus noise at a fixed SNR on the device,
denoises them with the ground-truth silent intervals, and computes the
speech-quality suite per clip: a quality snapshot per SNR in one command
(`cli/eval_synthetic.py`), without the reference's two-stage JSON/WAV
file dance.

A batch, on the device (the card unless `device="cpu"`):

  1. `device_mix_and_stft_denoiser`: K2's complement, the SNR mix, K2
     and the four STFTs in one K1 launch;
  2. the denoiser in the f32, bf16 (with `bf16_head_proj`) or int8
     profile (int8: K6 trunks, the K7 InpaintNet);
  3. cRM recover + complex multiply + iSTFT of the denoised spectrum in
     one K3 launch (`crm_istft`);
  4. the plain iSTFT (a synthesis-table matmul, as `sos_tpu` uses its
     plain `istft` there) of the clean spectrum and, with
     `noisy_baseline`, of the mixed one;

then on the host: the waveforms resampled to `metrics_sr` and the 11
metrics of `eval/speech.py` per clip, on 8 threads.
"""

from __future__ import annotations

from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from sos_tpu_torch.config import ExperimentConfig
from sos_tpu_torch.data.pipeline import (DenoiserBatcher,
                                         device_mix_and_stft_denoiser)
from sos_tpu_torch.dsp import audio_io
from sos_tpu_torch.dsp.stft import crm_istft, istft
from sos_tpu_torch.eval.speech import evaluate_metrics
from sos_tpu_torch.models import JointDenoiser
from sos_tpu_torch.models.layers import exact_fp32, resolve_device
from sos_tpu_torch.models.quant import QuantizedDenoiser

METRIC_KEYS = ("l1", "stoi", "csig", "cbak", "covl", "pesq", "ssnr_regular",
               "ssnr_shift", "ssnr_clip", "ssnr_exsi", "overall_snr")


def _packed(spec: torch.Tensor) -> torch.Tensor:
    """`(B, F, T, 2)` spectrum -> packed `(B, T, 2F)` [re | im]."""
    return torch.cat([spec[..., 0], spec[..., 1]], dim=1).transpose(1, 2)


def _nchw(spec: torch.Tensor) -> torch.Tensor:
    return spec.permute(0, 3, 1, 2)


class SyntheticDenoise:
    """The device part of a batch (steps 1-4 of the module docstring):
    `(batch dict) -> (denoised, clean, mixed or None)` waveforms on the
    device, `(B, (T-1) * hop)` each."""

    def __init__(self, cfg: ExperimentConfig, denoiser_state: Mapping,
                 profile: Optional[str] = None,
                 compute_dtype: str = "float32",
                 noisy_baseline: bool = False,
                 quant_kwargs: Optional[Dict] = None,
                 bf16_head_proj: bool = True, device="cuda"):
        if profile not in (None, "f32", "bf16", "int8"):
            raise ValueError(f"profile must be f32|bf16|int8, got {profile!r}")
        if profile in ("f32", None):
            compute_dtype = "float32"
        elif profile == "bf16":
            compute_dtype = "bfloat16"
        self.cfg = cfg
        self.device = resolve_device(device)
        self.noisy_baseline = noisy_baseline
        self.quant = self.model = None
        if profile == "int8":
            self.quant = QuantizedDenoiser(cfg.denoiser, denoiser_state,
                                           device=self.device,
                                           **(quant_kwargs or {}))
        else:
            self.model = JointDenoiser(
                cfg.denoiser, compute_dtype,
                profile == "bf16" and bf16_head_proj)
            self.model.load_state_dict(denoiser_state)
            self.model.to(self.device).eval()

    def _inputs(self, batch) -> Dict[str, torch.Tensor]:
        b = {k: torch.as_tensor(batch[k]).to(self.device)
             for k in ("clean", "noise", "snr", "bits")}
        return device_mix_and_stft_denoiser(b["clean"], b["noise"], b["snr"],
                                            b["bits"], self.cfg.data,
                                            self.cfg.stft)

    @torch.no_grad()
    def calibrate(self, batch) -> None:
        """int8: the activation scales from this batch's mixed and gated
        spectra (`sos_tpu` calibrates on the first batch); else nothing."""
        if self.quant is None or self.quant._calibrated:
            return
        with exact_fp32():
            d = self._inputs(batch)
        self.quant.calibrate([(d["mixed"], d["noise"])])

    @torch.no_grad()
    def __call__(self, batch):
        scfg = self.cfg.stft
        geometry = (scfg.n_fft, scfg.hop_length, scfg.win_length)
        with exact_fp32():
            d = self._inputs(batch)
            mixed_cat = _packed(d["mixed"])
            if self.quant is not None:
                crm_cat = self.quant.crm_cat(mixed_cat, _packed(d["noise"]))
            else:
                _, crm_cat = self.model.forward_packed(_nchw(d["mixed"]),
                                                       _nchw(d["noise"]))
            denoised = crm_istft(crm_cat, mixed_cat, *geometry)
            clean = istft(d["clean"], *geometry)
            mixed = istft(d["mixed"], *geometry) if self.noisy_baseline \
                else None
        return denoised, clean, mixed


def clip_metrics(out: np.ndarray, ref: np.ndarray, sr: int,
                 metrics_sr: int = 16000):
    """The 11 metrics of one clip against its reference, both resampled
    from `sr` to `metrics_sr`."""
    return evaluate_metrics(audio_io.resample(out, sr, metrics_sr),
                            audio_io.resample(ref, sr, metrics_sr),
                            sr=metrics_sr)


def evaluate_synthetic(
    cfg: ExperimentConfig,
    denoiser_state: Mapping,
    batcher: DenoiserBatcher,
    metrics_sr: int = 16000,
    max_batches: Optional[int] = None,
    compute_dtype: str = "float32",
    profile: Optional[str] = None,
    noisy_baseline: bool = False,
    quant_kwargs: Optional[Dict] = None,
    bf16_head_proj: bool = True,
    device="cuda",
) -> OrderedDict:
    """Run batched mix -> denoise -> metrics; returns the avg_* aggregates
    (and `num_clips`), `sos_tpu`'s keys and order.

    The batcher must be built with a pinned snr_idx (cfg.data.snr_idx) for
    a per-SNR report; denoising uses the ground-truth bitstreams.

    `profile` ("f32" | "bf16" | "int8", or None for `compute_dtype`):
    the serving profile to measure on this checkpoint; int8 calibrates
    on the first batch's mixed and gated spectra. `noisy_baseline` also
    scores the noisy mixtures against clean (`noisy_avg_*`).
    `quant_kwargs` go to `QuantizedDenoiser` (int8). `bf16_head_proj`
    applies to the bf16 profile only. `device`: the card unless "cpu"."""
    run = SyntheticDenoise(cfg, denoiser_state, profile, compute_dtype,
                           noisy_baseline, quant_kwargs, bf16_head_proj,
                           device)
    per_clip, noisy_clip = [], []
    sr = cfg.data.sample_rate
    with ThreadPoolExecutor(max_workers=8) as pool:
        for b_idx, batch in enumerate(batcher):
            if max_batches is not None and b_idx >= max_batches:
                break
            if b_idx == 0:
                run.calibrate(batch)
            denoised, clean, mixed = (
                None if t is None else t.cpu().numpy() for t in run(batch))
            # the host metric suite threads well (numpy releases the GIL)
            per_clip.extend(pool.map(
                lambda i: clip_metrics(denoised[i], clean[i], sr, metrics_sr),
                range(denoised.shape[0])))
            if noisy_baseline:
                noisy_clip.extend(pool.map(
                    lambda i: clip_metrics(mixed[i], clean[i], sr, metrics_sr),
                    range(mixed.shape[0])))

    agg = OrderedDict()
    agg["num_clips"] = len(per_clip)
    groups = [("avg_", per_clip)] + ([("noisy_avg_", noisy_clip)]
                                      if noisy_baseline else [])
    for prefix, clips in groups:
        for key in METRIC_KEYS:
            agg[f"{prefix}{key}"] = (float(np.nanmean([m[key] for m in clips]))
                                     if clips else float("nan"))
    return agg
