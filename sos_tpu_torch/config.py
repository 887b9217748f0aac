"""Typed configuration tree with the reference implementation's defaults.

The port's own copy of `sos_tpu/config.py`: the same dataclasses, field
names and defaults, so one config JSON drives both packages. The TPU-only
width-padding profiles (`fast_detector_config`, `fast_denoiser_config`)
are not carried over; the port runs the reference widths.

The reference scatters configuration across class-based `Config` objects
(model_1 common.py:30-88, model_2 common.py:25-83) and module-level
constants (model_1 dataset.py:29-49, model_2 dataset.py:23-40,
transform.py:6-8). Here everything lives in frozen dataclasses so a whole
experiment is one hashable, serializable value that can be closed over by
the models and the pipeline.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# DSP constants (reference transform.py:6-8; model_1 dataset.py:38-43)
# ---------------------------------------------------------------------------

N_FFT = 510          # 256 frequency bins
HOP_LENGTH = 158
WIN_LENGTH = 400
SAMPLE_RATE = 14000  # processing sample rate (model_1 dataset.py:38)
FRAME_RATE = 30.0    # "video" frame rate: 1 detector label per 1/30 s
METRICS_SAMPLE_RATE = 16000  # metrics computed at 16 kHz (m2 predict.py:461-466)

SNRS: Tuple[int, ...] = (-10, -7, -3, 0, 3, 7, 10)  # dataset.py:43 (both models)

CLIP_FRAMES = 60  # detector window: 60 video frames = 2 s (m1 dataset.py:33)
# floor(60 / 30 * 14000) = 28000 samples per detector clip (m1 dataset.py:40)
DETECTOR_CLIP_SAMPLES = int(CLIP_FRAMES / FRAME_RATE * SAMPLE_RATE)
DENOISER_CLIP_SECONDS = 2      # m2 dataset.py:30
DENOISER_OVERLAP_SECONDS = 1   # m2 dataset.py:31
FREQ_BINS = N_FFT // 2 + 1     # 256

# Number of STFT frames for a 28000-sample clip after reflect-centering:
# 1 + 28000 // 158 = 178
DETECTOR_SPEC_FRAMES = 1 + DETECTOR_CLIP_SAMPLES // HOP_LENGTH


@dataclasses.dataclass(frozen=True)
class StftConfig:
    """librosa-convention STFT (center=True, reflect pad, hann window)."""

    n_fft: int = N_FFT
    hop_length: int = HOP_LENGTH
    win_length: int = WIN_LENGTH

    @property
    def freq_bins(self) -> int:
        return self.n_fft // 2 + 1

    def num_frames(self, num_samples: int) -> int:
        """Frame count for a centered STFT of `num_samples` samples
        (1 + L // hop at even n_fft, 1 + (L - 1) // hop at odd)."""
        pad = self.n_fft // 2
        return 1 + (num_samples + 2 * pad - self.n_fft) // self.hop_length

    def num_output_samples(self, num_frames: int) -> int:
        """iSTFT output length for `num_frames` frames (librosa center=True)."""
        return (num_frames - 1) * self.hop_length


@dataclasses.dataclass(frozen=True)
class DetectorModelConfig:
    """Silent-interval detector (reference m1 networks.py:80-155).

    11 dilated Conv2d blocks on the 2-channel (re/im) spectrogram followed
    by a 1x1 projection, nearest-neighbor time resampling to the video
    frame grid, a BiLSTM and a 2-layer per-frame head.
    """

    freq_bins: int = FREQ_BINS
    in_channels: int = 2
    nf: int = 48
    outf: int = 8
    # (kernel, dilation) schedule, m1 networks.py:91-93
    kernel_sizes: Tuple[Tuple[int, int], ...] = (
        (1, 7), (7, 1), (5, 5), (5, 5), (5, 5), (5, 5),
        (5, 5), (5, 5), (5, 5), (5, 5), (5, 5),
    )
    dilations: Tuple[Tuple[int, int], ...] = (
        (1, 1), (1, 1), (1, 1), (2, 1), (4, 1), (8, 1),
        (16, 1), (32, 1), (1, 1), (2, 2), (4, 4),
    )
    lstm_hidden: int = 100
    fc_hidden: int = 100
    num_frames: int = CLIP_FRAMES  # default label grid (overridable per call)


@dataclasses.dataclass(frozen=True)
class DenoiserModelConfig:
    """Joint denoiser = InpaintNet -> ContextAggNet (m2 networks.py:152-217).

    The ContextAggNet conv schedule comes from m2 common.py:80-81: 14
    blocks, time-only dilations 1..32 then square dilations 1..32.
    """

    freq_bins: int = FREQ_BINS
    # ContextAggNet encoders
    nf_mixed: int = 96
    nf_noise: int = 48   # reference: nf_mixed // 2 (m2 networks.py:62)
    outf_mixed: int = 8
    outf_noise: int = 4
    kernel_sizes: Tuple[Tuple[int, int], ...] = (
        (1, 7), (7, 1), (5, 5), (5, 5), (5, 5), (5, 5), (5, 5),
        (5, 5), (5, 5), (5, 5), (5, 5), (5, 5), (5, 5), (5, 5),
    )
    dilations: Tuple[Tuple[int, int], ...] = (
        (1, 1), (1, 1), (1, 1), (2, 1), (4, 1), (8, 1), (16, 1),
        (32, 1), (1, 1), (2, 2), (4, 4), (8, 8), (16, 16), (32, 32),
    )
    lstm_hidden: int = 200
    fc_hidden: int = 600
    # InpaintNet channel plan (m2 networks.py:155-157)
    inpaint_ch: Tuple[int, int, int] = (64, 128, 256)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Synthetic-mixture dataset recipe (m1 dataset.py:29-49, m2 dataset.py:23-40)."""

    sample_rate: int = SAMPLE_RATE
    frame_rate: float = FRAME_RATE
    snrs: Tuple[int, ...] = SNRS
    snr_idx: Optional[int] = None       # pin a single SNR (None = random)
    clip_frames: int = CLIP_FRAMES      # detector window (video frames)
    silent_consecutive_frames: int = 1  # m1 dataset.py:32
    clip_seconds: int = DENOISER_CLIP_SECONDS      # denoiser window
    overlap_seconds: int = DENOISER_OVERLAP_SECONDS
    num_train_samples: int = 6000       # m1 dataset.py:31 (NUM_DATA)
    mix_norm: float = 0.5               # peak-normalize mixtures to 0.5
    random_seed: int = 10               # m1 dataset.py:34
    pred_random_seed: int = 100         # m1 dataset.py:35
    despeckle_min_run: int = 5          # mask run-length filter (m1 tools.py:784-790)
    # host LRU decode cache, in files: sized to hold AVSPEECH's 2,214-file
    # train split resident (~1 GB of 14 kHz f32 at ~10 s/clip)
    wav_cache_capacity: int = 2560


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer/schedule defaults (m1 common.py:55-64, agent.py:175-183)."""

    nr_epochs: int = 100
    batch_size: int = 15            # m1 common.py:56 (denoiser: 40, m2 common.py:52)
    lr: float = 1e-3
    lr_step_size: int = 15          # StepLR period in epochs
    lr_gamma: float = 0.1           # torch StepLR default gamma
    save_frequency: int = 1         # epochs
    # steps between mid-epoch `latest` checkpoints (0 = only per-epoch).
    # A checkpoint saved mid-epoch resumes EXACTLY: fit() replays the
    # epoch's deterministic batch order and skips the completed batches.
    save_step_frequency: int = 0
    val_frequency: int = 10         # steps
    visualize_frequency: int = 100  # steps
    seed: int = 0
    data_axis: str = "data"         # mesh axis name for data parallelism
    param_dtype: str = "float32"
    compute_dtype: str = "float32"  # conv trunks: "float32" or "bfloat16"
    # Rematerialize each conv block's forward in the backward pass
    # (training memory; torch.utils.checkpoint around sos_tpu's nn.remat
    # blocks).
    remat: bool = True
    # Skip optimizer/BN updates when any gradient is non-finite (corrupt
    # batch, low-precision overflow) instead of poisoning the state; the
    # step's `finite` metric records skips.
    skip_nonfinite_updates: bool = True


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str = "experiment"
    stft: StftConfig = dataclasses.field(default_factory=StftConfig)
    detector: DetectorModelConfig = dataclasses.field(default_factory=DetectorModelConfig)
    denoiser: DenoiserModelConfig = dataclasses.field(default_factory=DenoiserModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    output_root: str = "model_output"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "ExperimentConfig":
        raw = json.loads(text)

        def _tup(x):
            return tuple(tuple(v) if isinstance(v, list) else v for v in x)

        for key in ("kernel_sizes", "dilations"):
            if key in raw.get("detector", {}):
                raw["detector"][key] = _tup(raw["detector"][key])
            if key in raw.get("denoiser", {}):
                raw["denoiser"][key] = _tup(raw["denoiser"][key])
        if "inpaint_ch" in raw.get("denoiser", {}):
            raw["denoiser"]["inpaint_ch"] = tuple(raw["denoiser"]["inpaint_ch"])
        if "snrs" in raw.get("data", {}):
            raw["data"]["snrs"] = tuple(raw["data"]["snrs"])
        return ExperimentConfig(
            name=raw.get("name", "experiment"),
            stft=StftConfig(**raw.get("stft", {})),
            detector=DetectorModelConfig(**raw.get("detector", {})),
            denoiser=DenoiserModelConfig(**raw.get("denoiser", {})),
            data=DataConfig(**raw.get("data", {})),
            train=TrainConfig(**raw.get("train", {})),
            output_root=raw.get("output_root", "model_output"),
        )
