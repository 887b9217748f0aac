"""Fused two-stage pipeline (port of `sos_tpu/infer/fused.py`).

  waveform (B, 28000) -> STFT [K1] -> SilenceDetector [K4] -> sigmoid >=
  threshold -> bits (B, 60) -> sample mask + gate [K2] -> gated STFT [K1]
  -> JointDenoiser [K4] -> cRM recover + iSTFT [K3] -> waveform (B, 27966)

On the card every step between the models is a hand-written kernel and
the convolutions are cuDNN's; on the CPU (`device="cpu"`) every wrapper
runs its plain PyTorch version.

The int8 profile (`profile="int8"`, `models/quant.py`) runs the same
dataflow with int8-resident conv trunks: the detector trunk and both
ContextAggNet encoders on kernel K6, the InpaintNet on K7, one packed
STFT feeding both stages. Its static activation scales come from a
calibration on the first batch it sees (the mixed spectrum stands in
for both inputs), or from `calibration_path`, a JSON file of the schema
`{"denoiser": scales, "detector": scales}` that `sos_tpu` writes and
reads too, so one scale file serves both packages.

Numerics: `sos_tpu` runs its matmuls at Precision.HIGHEST and its convs
at Precision.DEFAULT, which is exact fp32 on the CPU it is compared on.
cuDNN defaults to TF32, so every call runs inside `exact_fp32`: the fp32
parts of every profile stay exact fp32 (the bf16 profile's convs are
bf16 anyway).

`shard(devices)` serves data-parallel in one process: one replica of
the pipeline a device, each call's batch split in order over them and
run at once, one host thread a device (`sos_tpu`'s batch-sharded SPMD
program over a mesh).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from sos_tpu_torch.config import ExperimentConfig
from sos_tpu_torch.dsp.mixing import mask_gate
from sos_tpu_torch.dsp.stft import crm_istft, stft, stft_cat
from sos_tpu_torch.models import JointDenoiser, SilenceDetector
from sos_tpu_torch.models.layers import exact_fp32, resolve_device
from sos_tpu_torch.models.quant import (CALIBRATION_SCHEMA_ERRORS,
                                        QuantizedDenoiser, QuantizedDetector,
                                        parse_calibration_file)
from sos_tpu_torch.parallel.mesh import gather_batch, make_mesh, shard_batch

# -- int16 wire format -----------------------------------------------------
# 16-bit PCM decodes to exact multiples of 1/32768, so shipping waveform
# chunks as int16 (k = round(y*32768)) halves the host<->device bytes
# with no input error for unresampled 16-bit audio.
WIRE_SCALE = 32768.0


def wire_encode(y: np.ndarray) -> np.ndarray:
    """Host side: f32 waveform -> int16 wire chunks (round half to even)."""
    return np.clip(np.round(np.asarray(y, np.float32) * WIRE_SCALE),
                   -32768.0, 32767.0).astype(np.int16)


def wire_decode(y) -> np.ndarray:
    """Host side: int16 wire chunks -> f32 waveform."""
    return np.asarray(y, np.float32) * np.float32(1.0 / WIRE_SCALE)


def _wire_in(mixed: torch.Tensor) -> torch.Tensor:
    """Ingest f32 chunks or int16 wire chunks."""
    if mixed.dtype == torch.int16:
        return mixed.float() * (1.0 / WIRE_SCALE)
    return mixed.float()


def _wire_out(y: torch.Tensor) -> torch.Tensor:
    """Emit: f32 waveform -> int16 wire samples."""
    return torch.clamp(torch.round(y * WIRE_SCALE),
                       -32768.0, 32767.0).to(torch.int16)


def _nchw(spec_cat: torch.Tensor) -> torch.Tensor:
    """Packed STFT (B, T, 2F) -> NCHW (B, 2, F, T) view."""
    b, t, two_f = spec_cat.shape
    return spec_cat.view(b, t, 2, two_f // 2).permute(0, 2, 3, 1)


class FusedDenoisePipeline:
    """Batched fixed-length clip denoising with silence detection."""

    def __init__(self, cfg: ExperimentConfig, detector_state: Mapping,
                 denoiser_state: Mapping, threshold: float = 0.5,
                 clip_seconds: float = 2.0, profile: str = "f32",
                 wire_dtype: str = "float32", bf16_head_proj: bool = True,
                 calibration_path: Optional[str] = None, device="cuda"):
        """`profile`: "f32" (reference-exact), "bf16" (bf16 conv trunks;
        with `bf16_head_proj`, bf16 LSTM input projections) or "int8"
        (int8 conv trunks and InpaintNet, bf16 LSTM input projections
        with `bf16_head_proj`; calibrates on its first batch).
        `detector_state` / `denoiser_state`: the models' state_dicts
        (`models/convert.py` makes them from `sos_tpu` variables).
        `wire_dtype`: "float32" | "int16", the dtype the denoised
        waveform is returned in; inputs may be f32 or int16 either way.
        `calibration_path` (int8): JSON file of the activation scales,
        loaded when present, written after the first self-calibration
        otherwise.
        `device`: "cuda" (default) or "cpu"."""
        if profile not in ("f32", "bf16", "int8"):
            raise ValueError(f"profile must be f32|bf16|int8, got {profile!r}")
        if wire_dtype not in ("float32", "int16"):
            raise ValueError(f"wire_dtype must be float32|int16, "
                             f"got {wire_dtype!r}")
        self.device = resolve_device(device)
        # what a replica on another device is built from (`shard`)
        self._replica_args = (cfg, detector_state, denoiser_state,
                              dict(threshold=threshold,
                                   clip_seconds=clip_seconds,
                                   profile=profile, wire_dtype=wire_dtype,
                                   bf16_head_proj=bf16_head_proj))
        self._mesh = self._replicas = None
        self.cfg = cfg
        self.profile = profile
        self.wire_dtype = wire_dtype
        self.threshold = threshold
        self.clip_samples = int(clip_seconds * cfg.data.sample_rate)
        self.num_frames = int(clip_seconds * cfg.data.frame_rate)
        self.ratio = cfg.data.sample_rate / cfg.data.frame_rate
        self._calibration_path = calibration_path
        # serializes the first-batch int8 calibration between threads
        self._calibration_lock = threading.Lock()
        self._quant = self._quant_det = None
        self.detector = self.denoiser = None
        if profile == "int8":
            self._quant = QuantizedDenoiser(cfg.denoiser, denoiser_state,
                                            bf16_head_proj=bf16_head_proj,
                                            device=self.device)
            self._quant_det = QuantizedDetector(cfg.detector, detector_state,
                                                bf16_head_proj=bf16_head_proj,
                                                device=self.device)
            return
        compute_dtype = {"f32": "float32", "bf16": "bfloat16"}[profile]
        # the f32 profile never takes the bf16 head: it is the exact one
        head_bf16 = bf16_head_proj and profile == "bf16"
        self.detector = SilenceDetector(cfg.detector, compute_dtype, head_bf16)
        self.denoiser = JointDenoiser(cfg.denoiser, compute_dtype, head_bf16)
        for model, state in ((self.detector, detector_state),
                             (self.denoiser, denoiser_state)):
            model.load_state_dict(state)
            model.to(self.device).eval()

    def _nf(self, n_samples: int) -> int:
        """Bits for an n-sample window: the pinned count for a clip, the
        rounded rate otherwise (copied from sos_tpu as it is)."""
        if n_samples == self.clip_samples:
            return self.num_frames
        return int(round(n_samples * self.cfg.data.frame_rate
                         / self.cfg.data.sample_rate))

    def _ingest(self, x) -> torch.Tensor:
        return _wire_in(torch.as_tensor(x, device=self.device))

    def _emit(self, y: torch.Tensor) -> torch.Tensor:
        return _wire_out(y) if self.wire_dtype == "int16" else y

    def _stft(self, y: torch.Tensor) -> torch.Tensor:
        scfg = self.cfg.stft
        return stft_cat(y, scfg.n_fft, scfg.hop_length, scfg.win_length)

    def _bits(self, mixed_cat: torch.Tensor, num_frames: int) -> torch.Tensor:
        if self._quant_det is not None:
            logits = self._quant_det.logits_cat(mixed_cat, num_frames)
        else:
            logits = self.detector.forward_nchw(_nchw(mixed_cat), num_frames)
        return (torch.sigmoid(logits) >= self.threshold).float()

    def _denoise(self, mixed: torch.Tensor, mixed_cat: torch.Tensor,
                 bits: torch.Tensor) -> torch.Tensor:
        scfg = self.cfg.stft
        gated = mask_gate(mixed, bits, self.ratio,
                          self.cfg.data.despeckle_min_run)
        gated_cat = self._stft(gated)
        if self._quant is not None:
            crm_cat = self._quant.crm_cat(mixed_cat, gated_cat)
        else:
            _, crm_cat = self.denoiser.forward_packed(_nchw(mixed_cat),
                                                      _nchw(gated_cat))
        return crm_istft(crm_cat, mixed_cat, scfg.n_fft, scfg.hop_length,
                         scfg.win_length)

    def _check_clip(self, mixed: torch.Tensor) -> None:
        if mixed.dim() != 2 or mixed.shape[-1] != self.clip_samples:
            raise ValueError(f"expected (B, {self.clip_samples}) clips, "
                             f"got {tuple(mixed.shape)}")

    @torch.no_grad()
    def __call__(self, mixed) -> Tuple[torch.Tensor, torch.Tensor]:
        """mixed: (B, clip_samples) -> (denoised (B, (T-1)*hop), bits (B, frames))."""
        if self._replicas is not None:
            return self._sharded("_call_local", mixed)
        return self._call_local(mixed)

    @torch.no_grad()
    def detect_bits(self, mixed) -> torch.Tensor:
        """(B, n) -> thresholded bits (B, _nf(n)); n is normally
        clip_samples, longer for a streaming detector-context halo."""
        if self._replicas is not None:
            return self._sharded("_detect_local", mixed)
        return self._detect_local(mixed)

    @torch.no_grad()
    def denoise_with_bits(self, mixed, bits) -> torch.Tensor:
        """Denoise with externally supplied (e.g. reconciled) bits."""
        if self._replicas is not None:
            return self._sharded("_denoise_local", mixed, bits)
        return self._denoise_local(mixed, bits)

    def _call_local(self, mixed):
        mixed = self._ingest(mixed)
        self._check_clip(mixed)
        self._maybe_calibrate(mixed)
        with exact_fp32():
            mixed_cat = self._stft(mixed)
            bits = self._bits(mixed_cat, self.num_frames)
            return self._emit(self._denoise(mixed, mixed_cat, bits)), bits

    def _detect_local(self, mixed):
        mixed = self._ingest(mixed)
        self._maybe_calibrate(mixed)
        with exact_fp32():
            return self._bits(self._stft(mixed), self._nf(mixed.shape[-1]))

    def _denoise_local(self, mixed, bits):
        mixed = self._ingest(mixed)
        self._check_clip(mixed)
        self._maybe_calibrate(mixed)
        bits = torch.as_tensor(bits, device=self.device).float()
        with exact_fp32():
            return self._emit(self._denoise(mixed, self._stft(mixed), bits))

    # -- data parallelism ------------------------------------------------

    def shard(self, devices: Sequence) -> "FusedDenoisePipeline":
        """Serve data-parallel over `devices` in this process (`sos_tpu`'s
        `shard(mesh)`): one replica of the pipeline a device (this one
        where the device is its own; elsewhere the weights copied, and an
        int8 replica takes this pipeline's calibration scales); then each
        call of `__call__`, `detect_bits` and `denoise_with_bits` splits
        its batch in order into one slice a device (the batch must divide
        the device count, as `sos_tpu`'s batch-sharded arrays require),
        runs the slices at once (one host thread a device) and returns
        the results concatenated on this pipeline's device. An int8
        pipeline not yet calibrated calibrates on the whole first batch,
        as the unsharded call does. Returns self."""
        mesh = make_mesh(devices=[resolve_device(d) for d in devices])
        cfg, det_state, den_state, kwargs = self._replica_args
        self._replicas = []
        for dev in mesh.devices:
            own = dev == self.device and self not in self._replicas
            self._replicas.append(self if own else FusedDenoisePipeline(
                cfg, det_state, den_state, device=dev, **kwargs))
        self._mesh = mesh
        return self

    def _sharded(self, method: str, mixed, *rest):
        if self._quant is not None and not self._quant._calibrated:
            self._maybe_calibrate(self._ingest(mixed))
        self._sync_scales()
        pieces = [shard_batch(torch.as_tensor(a), self._mesh)
                  for a in (mixed, *rest)]

        def run(i):
            rep = self._replicas[i]
            scope = (torch.cuda.device(rep.device)
                     if rep.device.type == "cuda" else contextlib.nullcontext())
            with scope, torch.no_grad():
                return getattr(rep, method)(*(p[i] for p in pieces))

        with ThreadPoolExecutor(max_workers=len(self._replicas)) as pool:
            results = list(pool.map(run, range(len(self._replicas))))
        if isinstance(results[0], tuple):
            return tuple(gather_batch(r, self.device) for r in zip(*results))
        return gather_batch(results, self.device)

    def _sync_scales(self) -> None:
        """Give every int8 replica this pipeline's scales (once a change)."""
        if self._quant is None or not self._quant._calibrated:
            return
        den = self._quant.calibration_state()
        det = self._quant_det.calibration_state()
        for rep in self._replicas:
            if rep is self:
                continue
            if not (rep._quant._calibrated and
                    rep._quant.calibration_state() == den):
                rep._quant.load_calibration(den)
            if not (rep._quant_det._calibrated and
                    rep._quant_det.calibration_state() == det):
                rep._quant_det.load_calibration(det)

    # -- int8 calibration ------------------------------------------------

    def ensure_calibrated(self) -> bool:
        """True when the pipeline can run with its final numerics: not
        int8, already calibrated, or persisted scales loaded here. Does
        not self-calibrate (the first real batch does that)."""
        if self._quant is None or self._quant._calibrated:
            return True
        return bool(self._calibration_path and
                    self.load_calibration_file(self._calibration_path))

    def load_calibration_file(self, path: str, strict: bool = False) -> bool:
        """Load persisted int8 scales. Non-strict: a missing, truncated or
        wrong-schema file logs a warning and returns False (the pipeline
        then self-calibrates and rewrites it). Strict: raises ValueError
        naming the file and the problem. A rejected file leaves the
        scales the pipeline had before."""
        def _fail(msg):
            if strict:
                raise ValueError(f"calibration file {path}: {msg}")
            logging.getLogger(__name__).warning(
                "calibration file %s: %s — self-calibrating instead",
                path, msg)
            return False

        state, problem = parse_calibration_file(path)
        if state is None:
            return _fail(problem)
        if "denoiser" not in state:
            return _fail(
                'missing the "denoiser" key (expected the schema this '
                "pipeline writes: {'denoiser': scales, 'detector': scales})")
        quant, quant_det = self._quant, self._quant_det
        snap_den = quant.calibration_state() if quant._calibrated else None
        snap_det = (quant_det.calibration_state() if quant_det._calibrated
                    else None)

        def _restore():
            for q, snap in ((quant, snap_den), (quant_det, snap_det)):
                if snap is not None:
                    q.load_calibration(snap)
                else:
                    q._calibrated = False

        try:
            quant.load_calibration(state["denoiser"])
            if "detector" not in state:
                _restore()
                return _fail('missing the "detector" scales this two-stage '
                             "pipeline needs")
            quant_det.load_calibration(state["detector"])
        except CALIBRATION_SCHEMA_ERRORS as exc:
            _restore()
            return _fail(f"wrong scale schema ({type(exc).__name__}: {exc})")
        return True

    def _maybe_calibrate(self, mixed: torch.Tensor) -> None:
        if self._quant is None or self._quant._calibrated:
            return
        with self._calibration_lock:
            if self._quant._calibrated:  # lost the race: already done
                return
            self._calibrate_locked(mixed)

    def _calibrate_locked(self, mixed: torch.Tensor) -> None:
        """Load the scale file, or calibrate on `mixed` (its spectrum is
        both denoiser inputs: an upper bound for the gated observation)
        and publish the scales first-writer-wins: the complete file goes
        to a temporary name and is hard-linked into place, which fails if
        another process published first; the loser adopts the winner's
        scales, so concurrent processes converge on one scale set."""
        path = self._calibration_path
        if path and self.load_calibration_file(path):
            return
        scfg = self.cfg.stft
        with exact_fp32():
            spec = stft(mixed, scfg.n_fft, scfg.hop_length, scfg.win_length)
        if not self._quant._calibrated:
            self._quant.calibrate([(spec, spec)])
        if not self._quant_det._calibrated:
            self._quant_det.calibrate([spec])
        if not path:
            return
        state = {"denoiser": self._quant.calibration_state(),
                 "detector": self._quant_det.calibration_state()}
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as fp:
                json.dump(state, fp, indent=1)
            try:
                os.link(tmp, path)
            except FileExistsError:
                if not self.load_calibration_file(path):
                    # the existing file is the unreadable one rejected
                    # above: overwrite it
                    os.replace(tmp, path)
            except OSError:
                # no hard links on this filesystem: atomic but
                # last-writer-wins, then adopt whatever file won
                os.replace(tmp, path)
                self.load_calibration_file(path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
